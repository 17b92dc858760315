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
              distinct_property) and d = 8 (the narrow instance's widest)
              with three spreads and a distinct_property; both exact and
              timed.
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
   lifecycle -- the allocation lifecycle through the port's Server
              under "tpu-binpack" (24 workers, the incremental feed on):
              C2M's 10,240 nodes and 32 service jobs x 4,000 allocs (cpu
              50, mem 32) placed by B1 into AllocBlocks, the last job
              tolerating disconnects for 300 s; then seven steps, each
              ending on a bounded wait_for_idle: 32 loaded nodes marked
              down (their allocs lost and replaced), 32 others drained and
              every alloc on them migrated (the caller plays the
              drainer), 2,000 allocs of 8 jobs reported failed an hour ago
              and rescheduled at once with their old nodes in B9's penalty
              column, 4 jobs moved to cpu 64 with max_parallel 1,000 and
              rolled by deployment-watcher evals until a no-op, one job's
              new version holding 16 canaries until they are reported
              healthy and promoted, then rolled, one job scaled to 2,000
              and one to 8,000 (B1 on the carry after B9's replacements),
              and 16 loaded nodes of the tolerant job disconnected (its
              allocs unknown with replacements and one
              max-disconnect-timeout follow-up each), 8 of them back (the
              originals kept, their replacements stopped). Then a system
              and a sysbatch job on cfg4's 1,024 nodes through a second
              Server: 8 nodes drained and 8 marked ineligible keep their
              allocs, a completed sysbatch run is not rerun, a destructive
              update of the system job replaces the alloc of every ready
              node. Gates after every step: the store walked against
              capacity (0 nodes over), every group at its desired live
              count, no live alloc on a down, drained or still
              disconnected node, no eval left blocked; each lost,
              migrated, failed or disconnected alloc replaced once (a
              failure's predecessor linked by next_allocation), every live
              alloc on the current version after the update and the
              canaries, exactly 16 canaries before promotion, the
              follow-up evals' kinds and count; at the end the feed's
              verify exact and no plain version on CUDA. Every B9 and B1
              launch of the steps is copied and replayed against its plain
              version (B9 in steps 1-3 and with a nonzero penalty column
              required), every B4 launch of the feed too. Prints each
              step's wall, B9 and B1 launches with their times by CUDA
              events, the applier's nodes_rejected and the span medians.
   autopilot -- the lifecycle on its own through the port's Server
              under "tpu-binpack" (24 workers, the feed on) with every
              actor running: heartbeats (heartbeat_ttl 10 s, the expiry
              rate at its default; a thread of the phase heartbeats every live
              node through heartbeat_batch once a second), the deployment
              watcher, the drainer and core GC (gc_interval 3,600 s: GC
              runs when the phase calls force_gc). C2M's 10,240 nodes,
              half with the bridge, a quarter with the calico CNI plugin,
              host volume "data" read-write on half and read-only on an
              eighth, four zones; 32 batch jobs x 4,000 (B1), 8 service
              jobs x 500 writing "data", 4 x 500 in bridge mode, 2 x 500
              in cni/calico, 16 single-writer CSI jobs of count 1 (a
              volume a zone) and one reader job x 256 on a
              multi-node-reader volume. The phase plays the clients
              (running and healthy, failed, complete). Steps: silence (32
              nodes, one holding a CSI writer, stop heartbeating: exactly
              they are marked down, their allocs replaced, the volume's
              one live writer in its zone), drain (32 nodes, 30 s
              deadline, migrate.max_parallel 2 on the service groups,
              paced by the drainer), auto-promote (4 jobs, 2 canaries
              each), auto-revert (2 jobs' bad canaries fail, the watcher
              reverts), progress deadline (3 s, no health report), GC (16
              batch jobs deregistered and completed, force_gc drops their
              allocs and blocks, the jobs and evals, the down nodes and
              stale claims; the feed's verify exact; then 8 batch jobs x
              4,000 through B1). Gates: the lifecycle's walk after every
              step, no node that kept heartbeating marked down (its
              status and the expiry log), no single-writer volume with
              two live writers, no drain group past its max_parallel at
              any sample (taken before each round of the clients' acks)
              and a paced group at max_parallel 2 at some sample, every
              drain completed and cleared, the deployments and versions
              the steps name (every live alloc of a reverted job on the
              reverted version at its count), no eval blocked; every B9 and B1 launch of the
              phase replayed against its plain version. Prints each
              step's wall, launches, spans and the feed's resyncs, twin
              uploads and flushes beside the node writes.
   replicated -- the C2M path through the replicated control plane
              (nomad_tpu_torch/raft): RaftCluster(3) with a data
              directory under build/ (each append fsync'd, a snapshot
              every REPL_SNAPSHOT applied entries), each server
              ServerConfig(device="cuda", 24 workers, "tpu-binpack",
              the bench-safe timers). The leader's Server schedules on
              the card (B1); every placement commits through the raft
              log and applies on all three replicas. The 10,240 nodes
              as one replicated upsert_nodes, the scheduler config set
              through the log, a warm job; wave 1: 32 batch jobs x
              4,000 (cpu 50, mem 32); wave 2: 32 more, the leader
              crashed once 8 of the 16 registered first are committed
              (the old leader has solved them all by then), the other
              16 registered after: a new leader is elected, its Server
              starts on the same card, re-runs the evals the crash
              left and finishes the wave; then the crashed server
              restarts from its data
              directory and catches up. Gates: every job exactly 4,000
              live allocs, every eval complete, 0 nodes over capacity on
              every replica, every replica's fingerprint (per-node
              usage, per-job live counts, eval statuses, the index) the
              leader's, each server snapshotted before the crash, the
              restarted server loaded its snapshot and its feed saw the
              restore sentinel and resynced, the new leader's scheduler
              config "tpu-binpack" from the replicated table, the crash
              in the middle of the wave, B1 launched under both leaders
              and every launch replayed exact against its plain version
              (B4's too), no plain version on CUDA, no follower feed
              twin on the card. Prints each wave's wall and allocs/s
              beside the "server" phase's, enqueue-to-commit p50 and
              p99, commit rounds, raft.fsync and raft.apply, the time to
              elect and to catch up, the snapshot's size, dump and
              restore times, and leader changes beside the injected one.
   http    -- the HTTP API (nomad_tpu_torch/api) on the card: the port's
              Server on C2M's 10,240 nodes (registered through the Server,
              as the reference has no HTTP node route) behind
              HTTPAgent(srv, port=0), driven by ApiClient. The scheduler
              configuration read and set to "tpu-binpack" over
              /v1/operator/scheduler/configuration; 32 batch jobs x 4,000
              (cpu 50, mem 32) through POST /v1/jobs, one of them sent as
              HCL-like text through /v1/jobs/parse; the evals waited on
              with blocking queries (/v1/evaluations?index=&wait=). A dry
              run (POST /v1/job/<id>/plan) of one more 4,000-alloc job,
              then that job registered; a service job of count 64 (B9);
              "tpu-solve" set over the operator endpoint and 8 more batch
              jobs (B5, the pick). Reads: /v1/metrics?format=prometheus
              parsed, /v1/traces holding every committed eval's span
              chain, /v1/event/stream?topic=Job seeing every
              registration, /v1/node/<id>/allocations against the store.
              Gates: 128,000 placed by the store and by the sum of
              /v1/job/<id>/allocations, 0 nodes over capacity, every
              X-Nomad-Index at most the store's index, every blocking
              query back within its wait, the dry run committing nothing
              and saying 4,000 to place, the launch after it solving
              against the usage built from the store exactly (its
              corrections folded), B1, B4, B9, B5 and the pick launched
              and each launch replayed exact against its plain version,
              no plain version on CUDA. Then three servers at 1,024 nodes
              (built as "replicated" builds them), an agent on each with
              its ReplicatedServer as writer: a job registered through a
              follower's agent (forwarded), read there with
              X-Nomad-KnownLeader and X-Nomad-LastContact, the leader
              crashed, the follower's /v1/status/leader naming the new
              one, a second job through it placed. Prints p50 and p99 per
              route (register, allocations read, plan), the blocking
              queries' wake latency (from the waking commit to the reply),
              the phase's wall and each kernel's launches.
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
27. wide   -- B11, B5 (with the pick and solve_batch), B13 and B14 above
              the one-CTA kernels' old ceiling of 16,384 nodes, at N_pad
              32,768 and 65,536 (phase_wide_kernels): each exact against
              its plain version (B13 also against B1, B14 against
              solve_batch), "main" timed beside the plain version and
              its bound.
28. big_cluster -- a 20,000-node cluster (N_pad 32,768) through the
              port's Server with 24 workers (phase_big_cluster): 16 x
              4,000 batch allocs (B1), 2 groups of 40,000 (B11' then
              B11), a 4,000-alloc CSI reader group (the generic B11), a
              512-alloc service group with a rack spread (B9), 16 x
              4,000 under "tpu-solve" (B5 and the pick); then the
              node-sharded service on one card at S = 1 and 2 (B13, B14,
              B15), 8 C2M and 8 tpu-solve jobs each. Gates: placed ==
              asked for every job, 0 nodes over capacity, every kernel
              of the path launched, every launch replayed against its
              plain version (exact; B9's scores within 1e-6), no plain
              version on CUDA, card == CPU on a 40,000 group and a
              tpu-solve wave at 20,000 nodes.
29. columns -- groups past the kernels' narrow caps of 8 resource
              columns, spreads and distinct_property constraints, which
              take the kernels' wide instances (phase_columns): a fresh
              port Server (24 workers, "tpu-binpack", BENCH_SAFE) on
              10,240 nodes (N_pad 16,384), each with six device groups of
              1-4 instances, 8 or 16 cores, meta attributes for 12
              spreads and 9 distinct_property targets of 4-32 values;
              then three groups, each drained: 512 allocs with six device
              asks, a core and a spread (B9 at d = 11); 512 with 12
              spreads (4 with explicit targets) and 9 distinct_property
              constraints, two binding (d = 4, s = 12, p = 9); 256 with
              five device asks, a core, 9 spreads and 2 properties (d =
              10, s = 9, p = 2). Gates after each step: every alloc live
              exactly once, no node over capacity in any column (usage,
              device instances and cores recomputed from the store's live
              allocs, each instance its node's and held once), every
              distinct_property count within its limit, each targeted
              spread's counts covering the group (a spread is a score:
              the excess over its targets is reported), B9 at the step's
              (d, s, p); every B9 launch replayed exact against
              solve_task_group_fused_ref (scores within 1e-6, the max
              printed), no plain version on CUDA. Then B9, B10, B16 (S 4
              on one card, bit-equal to B9), B11 (the "spreads" shape),
              B7 and B12 (cfg4's N_pad 1,024, K 512, V 512) against their
              plain versions at d 9, 12, 16 and 33 (B9, B10, B16 and B11
              also at s 9, 16, 33; B9, B10 and B16 at p 9, 16, 33; B11
              also at N_pad 64 with 4 spreads, more than its block's 2
              warps), each
              timed by CUDA events beside its bound; and each wrapper's
              refusal of tables past a CTA's shared memory, raised before
              any launch.
30. clients -- the client agent on the card's Server (phase_clients), in
              two steps. (a) The real entry point as a subprocess:
              `python -m nomad_tpu_torch agent --clients 4 --workers 4
              --algorithm tpu-binpack --data-dir <tmp> --port <free>`,
              driven through the port's CLI (`job run <hcl>`, `job
              status`, `alloc logs`) and ApiClient: a batch job of mock
              tasks (cpu 50, mem 32, a 10 MB ephemeral disk, run_for
              0.5 s) whose count is 80% of what the four fingerprinted
              nodes hold, within 256-1,024 (B1); a job of 4 asking
              `device "nvidia/gpu" { count = 1 }`; a raw_exec `echo`
              and a raw_exec `sleep`. Gates: every node carries the
              card's `nvidia/gpu/<name>` group, every batch alloc
              complete, the GPU allocs running on four nodes each
              holding gpu-0, the log line read back equal, the agent's
              /v1/metrics with solver launches > 0 and B1's launches
              > 0, and SIGTERM ending the agent with exit 0 and none of
              its executors or their tasks left. (b) Full width,
              in-process through cli.build_agent on the card: 256
              clients, each `Client(..., node=...)` with C2M's node
              shapes (mock.build_nodes), 24 workers, heartbeat TTL
              CL_FLEET_TTL; a 64-alloc service job with a rack spread
              (B9), then, once it is placed, C2M's job shape as one
              batch job of 4,000 mock tasks (run_for 0.2 s; B1): placed
              together, the B9 group is outside the solver service's
              carry and B1 overfills its nodes (ROADMAP §C12). While
              the completes land the phase calls the twin route
              (feed.device_used on the service's stream, the call a
              resync makes) every 0.25 s, so the device twin catches up
              with the freed capacity by B4 flushes (a re-upload past
              n_pad pending rows); then the service job is stopped and
              its 64 allocs' freed capacity reaches the twin in one B4
              flush. Gates: the batch complete and 64 running, every
              status reported by the clients through the
              ClientUpdateBatcher, 0 nodes over capacity, the stop's
              flush, the feed's verify exact, no client
              thread left after the stop, and every B1, B9 and B4
              launch of the step replayed exact against its plain
              version. Prints the wall from submit to the last complete,
              client.sync p50/p99, the hub's pushed deltas against its
              full resyncs and the peak thread count.

cfg4's two evals print the time the interpreter's garbage collector
took inside them (gc.callbacks): their walls are host-bound, and a full
collection can land in either.

``python3 chip_smoke.py --server`` runs the build, the Server phases
(C2M and tpu-solve, each on both feed arms) and the binpack sample
alone, then prints their records as one JSON line.
``python3 chip_smoke.py --devices`` runs the build, B9 on its variants
and the config 5 ("devices") and config 2 ("constraints") phases alone,
then prints their records as one JSON line.
``python3 chip_smoke.py --lifecycle`` runs the build and the "lifecycle"
phase alone, then prints its record and its B9 kernel record as JSON
lines.
``python3 chip_smoke.py --autopilot`` runs the build and the "autopilot"
phase alone, then prints its record as one JSON line.
``python3 chip_smoke.py --wide`` and ``--big-cluster`` run the build and
phase 27 or 28 alone, then print its record as one JSON line.
``python3 chip_smoke.py --columns`` runs the build and phase 29 alone,
then prints its record and the six kernels' records by width as JSON
lines, the card and the device summary.
``python3 chip_smoke.py --clients`` runs the build and phase 30 alone,
then prints its record and B1's, B9's and B4's launches on step (b) as
JSON lines.
``python3 chip_smoke.py --replicated`` runs the build and the
"replicated" phase alone, then prints its record and B1's and B4's
launches on it as JSON lines.
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
mean; ``solve_task_group_lifecycle`` is B9 on the lifecycle path, its
launches there, the replayed means of its launches with a node penalty
and ``penalty_launches``; B1's adds ``constraints_launches``, its
launches on the config 2 path, B1's and B4's ``lifecycle_launches``,
theirs on the lifecycle path, B1's, B4's and B9's
``autopilot_launches``, theirs on the autopilot path, and B1's and B4's
``replicated_launches``, theirs on the replicated path; B11's, B5's,
B13's and B14's ``wide``, phase 27's times at N_pad 32,768 and 65,536,
every kernel's ``big_cluster_launches``, its launches on phase 28's
path, B9's ``columns_launches``, its launches on phase 29's path, B1's,
B9's and B4's ``clients_launches``, theirs on phase 30's step (b), and
the ``by_columns`` of B9, B10, B16, B11, B7 and B12: phase 29's records
at each width past the narrow caps), and the card's name
and power limit; the last line is the device summary.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import json
import os
import random
import signal
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
# the reference bench's guard (bench.py:200, 1181, 1690) for a caller
# that never heartbeats: a node's TTL outlasts the run, and core GC runs
# only when asked
BENCH_SAFE = {"heartbeat_ttl": 3600.0, "gc_interval": 3600.0}
# waves of jobs a Server phase times. The service resyncs at the first
# launch that sees RESYNC_SOLVES (64) solves since the warm-up's resync;
# two waves are 2 x 64 (C2M) or 2 x 50 (tpu-solve) solves, past 64 by more
# than one launch's group (16 or 8), so a resync falls in the timed window
# whatever the grouping: on the fed arm the twin route, with its B4 flush
WAVES = 2
# the replicated phase: jobs a wave, jobs of wave 2 committed before the
# leader is crashed, applied entries between snapshots (low enough that
# every server snapshots during wave 1)
REPL_JOBS = 32
REPL_CRASH_AT = 8
REPL_SNAPSHOT = 48
# bench-safe raft timers, as the reference's bench sets for its
# in-process clusters (bench.py:1710-1715): the three servers share one
# interpreter, whose full garbage collections over three replicas of
# C2M state and whose copies and encodes of one 10,240-node command
# starve the heartbeat threads past the default 0.3 s election timeout
# (on the H100's host, five elections in a row while that command
# committed). Leader changes other than the injected crash are counted.
REPL_ELECTION_TIMEOUT = 2.0
REPL_HEARTBEAT = 0.1
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


def solve_inputs(torch, dev, rng, variant: str, n_pad: int = None):
    """B5/B6 inputs at the C2M width (or at ``n_pad`` with
    wide_capacity's rows): N_pad 16,384 with the build_nodes
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

    if n_pad is not None:
        n_nodes, cap = wide_capacity(n_pad)
    else:
        n_nodes, n_pad = ((MINI_NODES, PATH_PAD) if variant == "path"
                          else (N_NODES, N_PAD))
        cap = c2m_capacity(n_nodes)
    avail = np.zeros((n_pad, 4), np.float32)
    avail[:n_nodes] = cap
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
                 "eval.persist", "heartbeat.expire")


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
        failed_eval_unblock_interval=0.5, **BENCH_SAFE))
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


# --------------------------------------------------------------------------
# the lifecycle phase: C2M through the Server, then each step of an
# allocation's lifecycle (ROADMAP A1c); system and sysbatch on cfg4's nodes
# --------------------------------------------------------------------------

LC_JOBS = 32            # C2M's jobs cut from 64 to 32 (the autopilot
                        # phase takes the time the other half took)
LC_DOWN = 32            # nodes marked down (their allocs lost)
LC_DRAIN = 32           # nodes drained, every alloc on them migrated
LC_FAILED = 2000        # allocs reported failed an hour ago ...
LC_FAILED_JOBS = 8      # ... spread over this many jobs
LC_UPDATE_JOBS = 4      # jobs moved to cpu LC_UPDATE_CPU ...
LC_UPDATE_CPU = 64
LC_MAX_PARALLEL = 1000  # ... max_parallel destructive updates an eval
LC_CANARY = 16          # canaries of the canary job's new version
LC_DISCONNECT = 16      # nodes of the disconnect job disconnected ...
LC_RECONNECT = 8        # ... and this many of them back
LC_WINDOW = 300.0       # that job's max_client_disconnect (s)
LC_SYS_DRAIN = 8        # cfg4 nodes drained and ...
LC_SYS_INELIGIBLE = 8   # ... marked ineligible under the system jobs


def hold_off_actors(srv):
    """The caller plays the drainer and the deployment watcher."""
    srv.deployment_watcher.start = lambda: None
    srv.drainer.start = lambda: None


class Lifecycle:
    """The port's Server under "tpu-binpack" with the incremental feed
    on, and the records of the lifecycle phase's steps: each step's wall,
    its kernel launches (``_ext.COUNTS``), the B9 and B1 launches it made
    (their inputs and outputs copied as they are dispatched), the
    applier's rejections and the span split."""

    def __init__(self, card, device, workers, actors=False,
                 name="lifecycle", **config):
        """``actors``: the Server's drainer and deployment watcher run;
        else the caller plays them (held off). ``config`` overrides the
        bench-safe TTL and GC interval; ``name`` heads the printed
        lines."""
        from nomad_tpu_torch.core.server import Server, ServerConfig
        from nomad_tpu_torch.structs.operator import SchedulerConfiguration

        self.card = card
        self.name = name
        self.srv = Server(ServerConfig(
            num_workers=workers, eval_batch_size=1, device=device,
            sched_config=SchedulerConfiguration(
                scheduler_algorithm="tpu-binpack"),
            nack_timeout=900.0, failed_eval_followup_delay=3600.0,
            failed_eval_unblock_interval=0.5, **dict(BENCH_SAFE, **config)))
        if not actors:
            hold_off_actors(self.srv)
        self.steps = []
        self.b9, self.b1, self.b11 = [], [], []
        self.b4 = []
        self.desired = {}
        self.gone = set()        # nodes no live alloc may sit on
        self._step = "fill"

    # -- capture --

    @contextlib.contextmanager
    def capture(self):
        """B9 swapped where the placer calls it, B1 where the solver
        service calls it, B11 (the generic bulk scan of a group whose
        mask is per eval) where the placer calls it, B4 where the feed and
        the twin route call it: each launch's inputs and outputs copied
        (on its stream)."""
        from nomad_tpu_torch.tensor import placer, solver

        real_b9 = placer.solve_task_group_fused
        real_b1 = solver.solve_bulk_multi
        real_b11 = placer.solve_bulk

        def b9(*packed):
            snap = [t.clone() for t in packed]
            out = real_b9(*packed)
            self.b9.append((snap, out.clone(), self._step))
            return out

        def b1(used, *args, g):
            before = used.clone()
            keep = [a.clone() for a in args]
            out = real_b1(used, *args, g=g)
            self.b1.append((before, keep, g, out[0].clone(), out[1].clone(),
                            self._step))
            return out

        def b11(*args, **kw):
            keep = [a.clone() if hasattr(a, "clone") else a for a in args]
            out = real_b11(*args, **kw)
            self.b11.append((keep, dict(kw), out.clone(), self._step))
            return out

        placer.solve_task_group_fused = b9
        solver.solve_bulk_multi = b1
        placer.solve_bulk = b11
        try:
            with capture_b4(self.b4):
                yield
        finally:
            placer.solve_task_group_fused = real_b9
            solver.solve_bulk_multi = real_b1
            placer.solve_bulk = real_b11

    # -- driving --

    def idle(self, what):
        """Drain the queue, blocked evals included (a plan the applier
        rejected in part re-places its remainder), within a bound."""
        deadline = time.time() + 600.0
        while True:
            if not self.srv.wait_for_idle(max(1.0, deadline - time.time()),
                                          include_delayed=False):
                raise AssertionError(f"lifecycle {what}: the eval queue did "
                                     f"not drain: {blocked_report(self.srv)}")
            if self.srv.blocked.blocked_count() == 0:
                return
            if time.time() > deadline:
                raise AssertionError(f"lifecycle {what}: blocked evals did "
                                     f"not drain: {blocked_report(self.srv)}")
            time.sleep(0.05)

    def watch_until_noop(self, jobs, what, max_rounds=12):
        """The caller plays the deployment watcher: a deployment-watcher
        eval for each job, until a round submits no plan."""
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.structs import enums

        for _ in range(max_rounds):
            before = self.srv.plan_applier.stats["applied"]
            for j in jobs:
                self.srv.create_eval(mock.eval_for(
                    j, triggered_by=enums.TRIGGER_DEPLOYMENT_WATCHER))
            self.idle(what)
            if self.srv.plan_applier.stats["applied"] == before:
                return
        raise AssertionError(f"lifecycle {what}: no no-op watcher round in "
                             f"{max_rounds}")

    def step(self, name, fn):
        """Run one step: its wall, its launches, its B9/B1 captures, the
        applier's rejections in it, and the walk of every gate."""
        from nomad_tpu_torch import _ext
        from nomad_tpu_torch.obs import TRACER

        self._step = name
        before = _ext.COUNTS.snapshot()["launches"]
        rej0 = self.srv.plan_applier.stats["nodes_rejected"]
        applied0 = self.srv.plan_applier.stats["applied"]
        TRACER.clear()
        t_span = time.time()
        t0 = time.perf_counter()
        extra = fn() or {}
        wall = time.perf_counter() - t0
        after = _ext.COUNTS.snapshot()["launches"]
        launched = {k: after[k] - before[k] for k in after
                    if after[k] - before[k]}
        rec = {"step": name, "wall_s": wall, "launches": launched,
               "applied": self.srv.plan_applier.stats["applied"] - applied0,
               "nodes_rejected": (self.srv.plan_applier.stats[
                   "nodes_rejected"] - rej0),
               "spans": span_split(TRACER.spans(), t_span)}
        rec.update(extra)
        rec.update(self.walk(name))
        self.steps.append(rec)
        print(f"{self.name:<11} [{self.card}] {name}: {wall:.3f} s; launches "
              f"{launched}; applied {rec['applied']}, nodes_rejected "
              f"{rec['nodes_rejected']}, superseded {rec['superseded']} "
              f"(stops dropped {rec['stops_dropped']}, both since the "
              f"start); {extra}")
        return rec

    # -- gates --

    def walk(self, what) -> dict:
        """The store walked against capacity: no node over it, no id
        twice, every job at its desired live count (unknown allocs are
        not live), no live alloc on a node in ``gone``, and no alloc
        superseded but for a stop the applier dropped: on one Server a
        fresh placement finds its slot still live only when a rejected
        node took with it the stop of the alloc it replaces (ROADMAP
        §C8, both packages alike)."""
        superseded = self.srv.store.superseded
        dropped = self.srv.plan_applier.stops_dropped
        if superseded > dropped:
            raise AssertionError(f"lifecycle {what}: {superseded} allocs "
                                 f"superseded, {dropped} stops dropped "
                                 f"with a rejected node")
        snap = self.srv.store.snapshot()
        nodes = list(snap.nodes())
        row = {n.id: i for i, n in enumerate(nodes)}
        cap = np.stack([n.available_vec() for n in nodes])
        usage = np.zeros_like(cap)
        ids = set()
        n = 0
        live = Counter()
        on_gone = 0
        for a in snap.allocs():
            n += 1
            ids.add(a.id)
            if a.terminal_status():
                continue
            usage[row[a.node_id]] += a.allocated_vec
            if a.client_status == "unknown":
                continue
            live[a.job_id] += 1
            on_gone += a.node_id in self.gone
        over = int((usage > cap).any(axis=1).sum())
        if over or len(ids) != n:
            raise AssertionError(f"lifecycle {what}: {over} nodes over "
                                 f"capacity, {n - len(ids)} ids twice")
        bad = {j: (live[j], w) for j, w in self.desired.items()
               if live[j] != w}
        if bad:
            raise AssertionError(f"lifecycle {what}: live counts off "
                                 f"(live, desired): "
                                 f"{dict(list(bad.items())[:4])}")
        if on_gone:
            raise AssertionError(f"lifecycle {what}: {on_gone} live allocs "
                                 f"on down, drained or disconnected nodes")
        if self.srv.blocked.blocked_count():
            raise AssertionError(f"lifecycle {what}: evals left blocked: "
                                 f"{blocked_report(self.srv)}")
        return {"over_capacity": over, "allocs": n,
                "superseded": superseded, "stops_dropped": dropped}

    def chain(self, preds, what, linked=False):
        """Each predecessor replaced once: one alloc names it as
        previous_allocation; with ``linked`` the predecessor names that
        alloc as next_allocation (a rescheduled failure). Returns the
        replacements."""
        snap = self.srv.store.snapshot()
        by_prev = {}
        for a in snap.allocs():
            if a.previous_allocation:
                by_prev.setdefault(a.previous_allocation, []).append(a)
        repl = []
        for p in preds:
            got = by_prev.get(p.id, [])
            if len(got) != 1:
                raise AssertionError(f"lifecycle {what}: alloc {p.id} has "
                                     f"{len(got)} replacements")
            if linked and snap.alloc_by_id(p.id).next_allocation != got[0].id:
                raise AssertionError(f"lifecycle {what}: alloc {p.id}'s "
                                     f"next_allocation is not its "
                                     f"replacement")
            repl.append(got[0])
        return repl


def lc_loaded(srv, n, exclude=(), job_ids=None):
    """The ``n`` nodes holding most live allocs (of ``job_ids``, or of
    any job), ties by node id, none of ``exclude``."""
    counts = Counter()
    for a in srv.store.snapshot().allocs():
        if (not a.terminal_status() and a.node_id not in exclude
                and (job_ids is None or a.job_id in job_ids)):
            counts[a.node_id] += 1
    return sorted(counts, key=lambda nid: (-counts[nid], nid))[:n]


def lc_live_on(srv, node_ids):
    snap = srv.store.snapshot()
    return [a for nid in node_ids for a in snap.allocs_by_node(nid)
            if not a.terminal_status()]


def lc_client(srv, allocs, status, **fields):
    upds = []
    for a in allocs:
        u = a.copy_for_update()
        u.client_status = status
        for k, v in fields.items():
            setattr(u, k, v)
        upds.append(u)
    srv.update_allocs_from_client(upds)


def phase_lifecycle(torch, card, device="cuda", n_nodes=N_NODES,
                    n_jobs=LC_JOBS, k=K, scale=1.0, sys_nodes=None):
    """The lifecycle phase (ROADMAP A1c) through the port's Server under
    "tpu-binpack", 24 workers, the incremental feed on: C2M's nodes and
    jobs (``n_jobs`` x ``k`` allocs of cpu 50, mem 32 placed by B1 into
    AllocBlocks; the last job tolerates client disconnects for
    LC_WINDOW s), then seven steps, each ending on a bounded
    wait_for_idle: nodes marked down, nodes drained and their allocs
    migrated, failures of an hour ago rescheduled (B9 with the node
    penalty column), a destructive update with max_parallel, canaries
    held, promoted and rolled, a scale down and up, and nodes
    disconnected and half of them reconnected. Then system and sysbatch
    jobs on cfg4's nodes through a second Server. ``scale`` shrinks the
    step sizes (a CPU rehearsal). Returns (the launch counts of the
    steps, the record, the B9 kernel record)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import DrainStrategy, enums
    from nomad_tpu_torch.structs.alloc import DesiredTransition
    from nomad_tpu_torch.structs.job import UpdateStrategy
    from nomad_tpu_torch.tensor import incremental, kernels
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)
    from nomad_tpu_torch.tensor.solver import get_service

    def sized(n):
        return max(1, int(round(n * scale)))

    lc = Lifecycle(card, device, SERVER_WORKERS)
    srv = lc.srv
    t_setup = time.perf_counter()
    mock.build_nodes(srv.store, n_nodes, seed=0)
    jobs = [mock.service_job(k, cpu=50, mem=32) for _ in range(n_jobs)]
    discon = jobs[-1]
    discon.task_groups[0].max_client_disconnect_s = LC_WINDOW
    with incr_arm("1"), srv:
        for j in jobs:
            srv.register_job(j)
            lc.desired[j.id] = k
        lc.idle("fill")
        lc.walk("fill")
        fill_s = time.perf_counter() - t_setup
        print(f"lifecycle   setup and fill {fill_s:.2f} s ({n_nodes} nodes, "
              f"{n_jobs} jobs x {k} allocs, {SERVER_WORKERS} workers)")
        _ext.COUNTS.reset()
        with lc.capture():
            # 1. nodes marked down: their allocs lost and replaced
            down = lc_loaded(srv, sized(LC_DOWN), job_ids=None,
                             exclude={a.node_id for a in srv.store.snapshot(
                             ).allocs_by_job(discon.id)})
            lost = lc_live_on(srv, down)

            def step_down():
                for nid in down:
                    srv.heartbeats.remove(nid)   # their TTLs fired
                srv.mark_nodes_down(down)
                lc.gone.update(down)
                lc.idle("down")
                lc.chain(lost, "down")
                snap = srv.store.snapshot()
                if any(snap.alloc_by_id(a.id).client_status != "lost"
                       for a in lost):
                    raise AssertionError("lifecycle down: an alloc of a "
                                         "down node is not lost")
                return {"nodes": len(down), "lost": len(lost)}
            lc.step("down", step_down)

            # 2. nodes drained, their allocs migrated (the caller plays
            # the drainer)
            drained = lc_loaded(srv, sized(LC_DRAIN), exclude=set(down))
            moved = lc_live_on(srv, drained)

            def step_drain():
                for nid in drained:
                    srv.update_node_drain(nid, DrainStrategy(deadline_s=600))
                lc.idle("drain")
                touched = {a.job_id for a in moved}
                evals = [mock.eval_for(
                    j, triggered_by=enums.TRIGGER_NODE_DRAIN)
                    for j in jobs if j.id in touched]
                srv.update_alloc_desired_transitions(
                    {a.id: DesiredTransition(migrate=True) for a in moved},
                    evals)
                lc.gone.update(drained)
                lc.idle("drain")
                lc.chain(moved, "drain")
                return {"nodes": len(drained), "migrated": len(moved)}
            lc.step("drain", step_drain)

            # 3. failures of an hour ago, rescheduled now away from their
            # nodes (the penalty column of B9)
            fjobs = jobs[8:8 + LC_FAILED_JOBS]
            per_job = sized(LC_FAILED) // LC_FAILED_JOBS
            failed = []
            snap = srv.store.snapshot()
            for j in fjobs:
                live = sorted((a for a in snap.allocs_by_job(j.id)
                               if not a.terminal_status()),
                              key=lambda a: a.name)
                stride = max(1, len(live) // per_job)
                failed.extend(live[::stride][:per_job])

            def step_failed():
                lc_client(srv, failed, enums.ALLOC_CLIENT_FAILED,
                          task_finished_at=time.time() - 3600.0)
                lc.idle("failures")
                repl = lc.chain(failed, "failures", linked=True)
                on_old = sum(r.node_id == p.node_id
                             for r, p in zip(repl, failed))
                tracked = sum(bool(r.reschedule_tracker
                                   and r.reschedule_tracker.events)
                              for r in repl)
                if tracked != len(repl):
                    raise AssertionError("lifecycle failures: a replacement "
                                         "without its reschedule tracker")
                return {"failed": len(failed), "jobs": len(fjobs),
                        "on_their_old_node": on_old}
            lc.step("failures", step_failed)

            # 4. a destructive update with max_parallel, rolled by the
            # caller's deployment-watcher evals
            ujobs = jobs[16:16 + LC_UPDATE_JOBS]

            def step_update():
                new = []
                for j in ujobs:
                    j2 = copy.deepcopy(srv.store.snapshot().job_by_id(j.id))
                    j2.task_groups[0].tasks[0].resources.cpu = LC_UPDATE_CPU
                    j2.task_groups[0].update = UpdateStrategy(
                        max_parallel=sized(LC_MAX_PARALLEL))
                    srv.register_job(j2)
                    new.append(j2)
                lc.idle("update")
                lc.watch_until_noop(new, "update")
                return lc_versions(srv, ujobs, "update")
            lc.step("update", step_update)

            # 5. canaries held until promotion, then rolled
            cjob = jobs[20]

            def step_canary():
                j2 = copy.deepcopy(srv.store.snapshot().job_by_id(cjob.id))
                j2.task_groups[0].tasks[0].config = {"command": "/bin/new"}
                j2.task_groups[0].update = UpdateStrategy(
                    canary=LC_CANARY, max_parallel=sized(LC_MAX_PARALLEL))
                srv.register_job(j2)
                lc.idle("canary")
                lc.watch_until_noop([j2], "canary hold")
                snap = srv.store.snapshot()
                job = snap.job_by_id(cjob.id)
                live = [a for a in snap.allocs_by_job(cjob.id)
                        if not a.terminal_status()]
                canaries = [a for a in live if a.canary]
                old = [a for a in live if a.job_version != job.version]
                if len(canaries) != LC_CANARY or len(old) != k:
                    raise AssertionError(
                        f"lifecycle canary: {len(canaries)} canaries and "
                        f"{len(old)} old allocs before promotion, want "
                        f"{LC_CANARY} and {k}")
                lc_client(srv, canaries, enums.ALLOC_CLIENT_RUNNING,
                          deployment_status={"healthy": True})
                dep = snap.latest_deployment_by_job(cjob.id)
                srv.promote_deployment(dep.id)
                lc.idle("canary")
                lc.watch_until_noop([job], "canary roll")
                out = lc_versions(srv, [cjob], "canary")
                out["canaries"] = len(canaries)
                return out
            lc.step("canary", step_canary)

            # 6. one job scaled down to k / 2, another up to 2 k (B1 on
            # the carry after B9's replacements)
            sjobs = jobs[21:23]

            def step_scale():
                for j, count in zip(sjobs, (k // 2, 2 * k)):
                    srv.scale_job(j.id, j.task_groups[0].name, count)
                    lc.desired[j.id] = count
                lc.idle("scale")
                return {"counts": [lc.desired[j.id] for j in sjobs]}
            lc.step("scale", step_scale)

            # 7. nodes of the disconnect-tolerant job disconnected, then
            # half of them back
            cut = lc_loaded(srv, sized(LC_DISCONNECT), exclude=lc.gone,
                            job_ids={discon.id})
            back = cut[:max(1, sized(LC_RECONNECT))]
            gone_for_good = [n for n in cut if n not in back]

            def step_disconnect():
                tolerant = [a for a in lc_live_on(srv, cut)
                            if a.job_id == discon.id]
                others = [a for a in lc_live_on(srv, cut)
                          if a.job_id != discon.id]
                for nid in cut:
                    srv.heartbeats.remove(nid)   # their TTLs fired
                srv.mark_nodes_down(cut)
                lc.gone.update(cut)
                lc.idle("disconnect")
                snap = srv.store.snapshot()
                if any(snap.node_by_id(n).status != "disconnected"
                       for n in cut):
                    raise AssertionError("lifecycle disconnect: a node of "
                                         "the tolerant job is not "
                                         "disconnected")
                if any(snap.alloc_by_id(a.id).client_status != "unknown"
                       for a in tolerant):
                    raise AssertionError("lifecycle disconnect: a tolerant "
                                         "alloc is not unknown")
                repl = lc.chain(tolerant + others, "disconnect")
                fups = [e for e in snap.evals() if e.wait_until > 0]
                kinds = Counter(e.triggered_by for e in fups)
                want_t = {snap.node_by_id(n).status_updated_at + LC_WINDOW
                          for n in cut}
                if (kinds != Counter({enums.TRIGGER_MAX_DISCONNECT_TIMEOUT:
                                      len(tolerant)})
                        or not {e.wait_until for e in fups} <= want_t):
                    raise AssertionError(f"lifecycle disconnect: follow-up "
                                         f"evals {dict(kinds)}, want "
                                         f"{len(tolerant)} max-disconnect-"
                                         f"timeout at the window's end")
                for nid in back:
                    srv.update_node_status(nid, enums.NODE_STATUS_READY)
                lc.gone.difference_update(back)
                lc.idle("reconnect")
                snap = srv.store.snapshot()
                kept = [a for a in tolerant if a.node_id in back]
                stale = [r for r, p in zip(repl, tolerant + others)
                         if p.node_id in back and p.job_id == discon.id]
                if any(snap.alloc_by_id(a.id).desired_status != "run"
                       for a in kept) or any(
                        snap.alloc_by_id(r.id).desired_status != "stop"
                        for r in stale):
                    raise AssertionError("lifecycle reconnect: an original "
                                         "stopped or its replacement kept")
                lc_client(srv, [snap.alloc_by_id(a.id) for a in kept],
                          enums.ALLOC_CLIENT_RUNNING)
                lc.idle("reconnect")
                return {"nodes": len(cut), "reconnected": len(back),
                        "unknown": len(tolerant), "lost": len(others),
                        "kept": len(kept), "replacements_stopped": len(stale),
                        "followups": len(fups)}
            lc.step("disconnect", step_disconnect)
            counts = _ext.COUNTS.snapshot()
            feed = incremental.feed_for(srv.store)
            verified = feed.force_verify()
            feed_stats = feed.stats()
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"lifecycle: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    if not verified:
        raise AssertionError(f"lifecycle: the feed's verify failed: "
                             f"{incremental.GLOBAL.violations[-1:]}")
    launched = counts["launches"]
    lc.gone = set()

    # the system and sysbatch jobs on cfg4's nodes
    sys_rec = run_lifecycle_system(torch, card, device,
                                   sys_nodes or CFG4_NODES, scale)

    # replays: every B9 and B1 launch of the steps against its plain
    # version (B9 choices and founds exact, scores within SCORE_TOL, and
    # equal to the path's output; B1 exact), and B4's
    b9_steps = Counter(c[2] for c in lc.b9)
    pen = [c for c in lc.b9 if (c[0][1][:, 0] >= 0).any()]
    if sum(b9_steps[s] for s in ("down", "drain", "failures")) < 1:
        raise AssertionError(f"lifecycle: B9 did not launch in steps 1-3: "
                             f"{dict(b9_steps)}")
    if not pen:
        raise AssertionError("lifecycle: no B9 launch carried a node "
                             "penalty")
    err = 0.0
    for i, (packed, out, _) in enumerate(lc.b9):
        got = kernels.solve_task_group_fused(*packed)
        want = kernels.solve_task_group_fused_ref(*packed)
        if not (torch.equal(got[:2], want[:2]) and torch.equal(got, out)):
            raise AssertionError(f"lifecycle: B9 launch {i} differs from "
                                 f"its plain version or the path's output")
        err = max(err, score_err(got[2], want[2], f"lifecycle B9 {i}"))
    for i, (before, args, g, used, cnt, _) in enumerate(lc.b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"lifecycle: B1 launch {i} differs from "
                                 f"its plain version or the path's output")
    b4 = replay_b4(torch, lc.b4, "lifecycle")
    timed = {}
    if device != "cpu":
        for s in lc.steps:
            b9s = [c for c in lc.b9 if c[2] == s["step"]]
            b1s = [c for c in lc.b1 if c[5] == s["step"]]
            s["b9_ms"] = [cuda_time_ms(
                torch, lambda _, p=c[0]: kernels.solve_task_group_fused(*p),
                reps=3, warmup=1) for c in b9s]
            s["b1_ms"] = [cuda_time_ms(
                torch, lambda u, c=c: solve_bulk_multi(u, *c[1], g=c[2]),
                setup=c[0].clone, reps=3, warmup=1) for c in b1s]
        first = pen[0][0]
        timed = {
            "ms": statistics.mean(cuda_time_ms(
                torch, lambda _, p=c[0]: kernels.solve_task_group_fused(*p),
                reps=5) for c in pen),
            "plain_ms": cuda_time_ms(
                torch, lambda _: kernels.solve_task_group_fused_ref(*first),
                reps=2, warmup=1)}
        timed["bound_ms"], timed["bound_by"] = scan_bound(first)
        timed["ms_per_step"] = timed["ms"] / active_steps(first)
    rec = {"nodes": n_nodes, "jobs": n_jobs, "allocs": n_jobs * k,
           "fill_s": fill_s, "steps": lc.steps, "system": sys_rec,
           "b9_launches_by_step": dict(b9_steps),
           "b9_penalty_launches": len(pen),
           "b9_penalty_rows": [int((c[0][1][:, 0] >= 0).sum()) for c in pen],
           "b9_k": [int(c[0][1].shape[0]) for c in lc.b9],
           "b1_launches": len(lc.b1), "b4": b4, "feed": feed_stats,
           "launches": {k: v for k, v in launched.items() if v},
           "card": card}
    for s in lc.steps:
        print(f"lifecycle   [{card}] {s['step']}: wall {s['wall_s']:.3f} s; "
              f"B9 {s['launches'].get('solve_task_group', 0)} launches "
              f"(event ms {[round(x, 4) for x in s.get('b9_ms', [])]}), "
              f"B1 {s['launches'].get('bulk_fill', 0)} "
              f"(event ms {[round(x, 4) for x in s.get('b1_ms', [])]}); "
              f"nodes_rejected {s['nodes_rejected']}; span p50 ms "
              + "; ".join(f"{n} {v['p50_ms']:.3f} ({v['n']})"
                          for n, v in s["spans"].items()))
    print(f"lifecycle   [{card}] B9 {len(lc.b9)} launches by step "
          f"{dict(b9_steps)}, {len(pen)} with a node penalty (rows "
          f"{rec['b9_penalty_rows']}), replays exact (scores within "
          f"{SCORE_TOL}, max {err:.3g}); B1 {len(lc.b1)} launches, replays "
          f"exact; B4 {b4}; the penalty launches {timed}; feed {feed_stats}")
    kernel = {"name": "solve_task_group_lifecycle", "source":
              "nomad_tpu_torch/csrc/task_group.cu",
              "replaces": "nomad_tpu/tensor/kernels.py:448",
              "launches": launched["solve_task_group"], "max_abs_err": err,
              "library_ms": None, "penalty_launches": len(pen)}
    kernel.update(timed)
    get_service(device).stop()
    return launched, rec, kernel


def lc_versions(srv, jobs, what) -> dict:
    """Every live alloc of the jobs on its job's current version."""
    snap = srv.store.snapshot()
    old = 0
    for j in jobs:
        version = snap.job_by_id(j.id).version
        old += sum(1 for a in snap.allocs_by_job(j.id)
                   if not a.terminal_status() and a.job_version != version)
    if old:
        raise AssertionError(f"lifecycle {what}: {old} live allocs on an "
                             f"old job version")
    return {"old_version_live": old}


def run_lifecycle_system(torch, card, device, n_nodes, scale):
    """A system job and a sysbatch job on every one of cfg4's nodes
    through a second Server; then nodes drained and nodes marked
    ineligible (their system allocs keep running, as the reference's
    system_sched.py:80-100 keeps them); a sysbatch run completed is not
    rerun; then a destructive update of the system job, which replaces
    the alloc of every ready node and leaves the not-ready ones'."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.structs import DrainStrategy, enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration

    srv = Server(ServerConfig(
        num_workers=4, eval_batch_size=1, device=device,
        sched_config=SchedulerConfiguration(
            scheduler_algorithm="tpu-binpack"), nack_timeout=900.0,
        **BENCH_SAFE))
    hold_off_actors(srv)
    nodes = []
    for i in range(n_nodes):
        n = mock.node(id=f"lc-sys-node-{i:04d}", name=f"lc-sys-node-{i:04d}")
        n.attributes["rack"] = f"r{i % 20}"
        n.resources.cpu = 16000
        n.resources.memory_mb = 32768
        n.compute_class()
        nodes.append(n)
    sysj = mock.system_job(id="lc-sys", name="lc-sys")
    sysj.task_groups[0].tasks[0].resources.cpu = 400
    sysj.task_groups[0].tasks[0].resources.memory_mb = 128
    batch = mock.sysbatch_job(id="lc-sysbatch", name="lc-sysbatch")
    walls = {}

    def idle(what):
        if not srv.wait_for_idle(300.0, include_delayed=False):
            raise AssertionError(f"lifecycle system {what}: the eval queue "
                                 f"did not drain")

    def per_node(job_id):
        out = Counter()
        snap = srv.store.snapshot()
        for a in snap.allocs_by_job(job_id):
            if not a.terminal_status():
                out[a.node_id] += 1
        return out, snap

    with srv:
        srv.register_nodes(nodes)
        t0 = time.perf_counter()
        srv.register_job(sysj)
        srv.register_job(batch)
        idle("place")
        walls["place_s"] = time.perf_counter() - t0
        for jid in (sysj.id, batch.id):
            got, _ = per_node(jid)
            if len(got) != n_nodes or set(got.values()) != {1}:
                raise AssertionError(f"lifecycle system: {jid} on "
                                     f"{len(got)} nodes, want one alloc on "
                                     f"each of {n_nodes}")
        n_drain = max(1, int(LC_SYS_DRAIN * scale))
        n_inel = max(1, int(LC_SYS_INELIGIBLE * scale))
        drained = [n.id for n in nodes[:n_drain]]
        inel = [n.id for n in nodes[n_drain:n_drain + n_inel]]
        t0 = time.perf_counter()
        for nid in drained:
            srv.update_node_drain(nid, DrainStrategy(deadline_s=600))
        for nid in inel:
            srv.update_node_eligibility(nid, enums.NODE_SCHED_INELIGIBLE)
        idle("drain")
        _, snap = per_node(batch.id)
        lc_client(srv, [a for a in snap.allocs_by_job(batch.id)],
                  enums.ALLOC_CLIENT_COMPLETE)
        srv.create_eval(mock.eval_for(srv.store.snapshot().job_by_id(
            batch.id), triggered_by=enums.TRIGGER_NODE_UPDATE))
        idle("sysbatch rerun")
        walls["drain_s"] = time.perf_counter() - t0
        allb = srv.store.snapshot().allocs_by_job(batch.id)
        if len(allb) != n_nodes:
            raise AssertionError(f"lifecycle system: sysbatch has "
                                 f"{len(allb)} allocs after its run "
                                 f"completed, want {n_nodes} (no rerun)")
        t0 = time.perf_counter()
        j2 = copy.deepcopy(srv.store.snapshot().job_by_id(sysj.id))
        j2.task_groups[0].tasks[0].resources.cpu = 450
        srv.register_job(j2)
        idle("update")
        walls["update_s"] = time.perf_counter() - t0
        got, snap = per_node(sysj.id)
        version = snap.job_by_id(sysj.id).version
        not_ready = set(drained) | set(inel)
        bad = 0
        for a in snap.allocs_by_job(sysj.id):
            if a.terminal_status():
                continue
            if a.node_id in not_ready:
                bad += a.job_version == version
            else:
                bad += (a.job_version != version
                        or not a.previous_allocation)
        if len(got) != n_nodes or set(got.values()) != {1} or bad:
            raise AssertionError(f"lifecycle system update: {bad} allocs on "
                                 f"the wrong version, {len(got)} nodes "
                                 f"covered")
        stats = dict(srv.plan_applier.stats)
    rec = dict(walls, nodes=n_nodes, drained=len(drained),
               ineligible=len(inel), nodes_rejected=stats["nodes_rejected"],
               applied=stats["applied"])
    print(f"lifecycle   [{card}] system and sysbatch on {n_nodes} nodes: "
          f"placed in {walls['place_s']:.3f} s, {len(drained)} drained and "
          f"{len(inel)} ineligible kept, sysbatch not rerun "
          f"({walls['drain_s']:.3f} s), the update {walls['update_s']:.3f} "
          f"s; nodes_rejected {stats['nodes_rejected']}")
    return rec


# the "autopilot" phase: the Server's lifecycle on its own, at C2M width
AP_TTL = 10.0             # heartbeat_ttl (s): the largest gap between two
                          # heartbeat_batch calls was 2.05 s at 5 s (one
                          # call took 1.04 s on a loaded host)
AP_BEAT = 1.0             # the phase's heartbeat cadence (s)
AP_BATCH_JOBS = 32        # batch jobs x AP_BATCH_K (cpu 50, mem 32)
AP_BATCH_K = 4000
AP_VOL_JOBS = 8           # service jobs x AP_SVC_K writing host volume data
AP_BRIDGE_JOBS = 4        # ... in bridge mode
AP_CNI_JOBS = 2           # ... in cni/calico
AP_SVC_K = 500
AP_CSI_JOBS = 16          # single-writer CSI jobs of count 1, a zone each
AP_READER_K = 256         # the reader job on a multi-node-reader volume
AP_SILENT = 32            # nodes that stop heartbeating
AP_DRAIN = 32             # nodes drained ...
AP_DRAIN_DEADLINE = 30.0  # ... with this deadline (s)
AP_MIGRATE = 2            # the service groups' migrate.max_parallel
AP_DRAIN_ROUNDS = 16      # the most drain rounds a drained node needs: a
                          # group's allocs there over its max_parallel
                          # (BestFit packs hundreds of one group on a node)
AP_DRAIN_PACED = 4        # of the drained nodes, those picked for a paced
                          # group of three or more allocs (where
                          # max_parallel 2 binds) ...
AP_DRAIN_PACED_ROUNDS = 48  # ... needing at most this many rounds
AP_PROMOTE_JOBS = 4       # service jobs updated with canaries ...
AP_CANARY = 2             # ... this many each, auto_promote
AP_ROLL = 250             # max_parallel of the updates
AP_REVERT_JOBS = 2        # bad updates with auto_revert
AP_DEADLINE = 3.0         # the progress deadline of one job's update (s)
AP_GC_JOBS = 16           # batch jobs deregistered before force_gc
AP_NEW_JOBS = 8           # batch jobs x AP_BATCH_K placed after it


def ap_nodes(n_nodes: int):
    """mock.build_nodes' nodes with the autopilot's fingerprints: the
    bridge on half, the calico CNI plugin on a quarter, host volume
    "data" read-write on half and read-only on an eighth; ``zone`` (four)
    is the CSI volumes' topology."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import ClientHostVolumeConfig

    rng = random.Random(0)
    out = []
    for i in range(n_nodes):
        n = mock.node(id=f"ap-node-{i:05d}", name=f"ap-node-{i:05d}")
        n.attributes["rack"] = f"r{i % 20}"
        n.attributes["zone"] = f"z{i % 4}"
        n.resources.cpu = rng.choice([8000, 16000, 32000])
        n.resources.memory_mb = rng.choice([16384, 32768, 65536])
        if i % 2 == 0:
            n.attributes["network.bridge"] = "true"
            n.host_volumes["data"] = ClientHostVolumeConfig(
                name="data", path="/srv/data")
        elif i % 8 == 1:
            n.host_volumes["data"] = ClientHostVolumeConfig(
                name="data", path="/srv/data", read_only=True)
        if i % 4 == 3:
            n.attributes["plugins.cni.version.calico"] = "3.26"
        n.compute_class()
        out.append(n)
    return out


class Beats:
    """The phase's heartbeat thread: ``heartbeat_batch`` of every node not
    silenced, about once every AP_BEAT s, on a thread of its own; each
    call's start and length are kept."""

    def __init__(self, srv, node_ids):
        import threading

        self.srv = srv
        self.alive = list(node_ids)
        self.silent = set()
        self.calls = []
        self.errors = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ap-heartbeats")

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def silence(self, node_ids):
        with self._lock:
            self.silent.update(node_ids)
            self.alive = [n for n in self.alive if n not in self.silent]

    def _run(self):
        while True:
            with self._lock:
                ids = list(self.alive)
            t0 = time.monotonic()
            try:
                self.srv.heartbeat_batch(ids)
            except Exception as e:  # noqa: BLE001 - a gate reads it
                self.errors.append(repr(e))
            self.calls.append((t0, time.monotonic() - t0))
            if self._stop.wait(AP_BEAT):
                return

    def report(self) -> dict:
        starts = [t for t, _ in self.calls]
        gaps = [b - a for a, b in zip(starts, starts[1:])]
        return {"calls": len(self.calls),
                "max_gap_s": max(gaps, default=0.0),
                "max_call_s": max((d for _, d in self.calls), default=0.0),
                "p50_call_s": (statistics.median(d for _, d in self.calls)
                               if self.calls else 0.0)}


class Clients:
    """The clients of the autopilot's nodes: every pending alloc of a
    service job reported running and healthy (a job in ``quiet`` gets no
    report; its canaries in ``failing`` are reported failed), and every
    alloc the server stopped on a node that still heartbeats reported
    complete. A silenced node's client reports nothing."""

    def __init__(self, srv, beats, service_ids):
        self.srv = srv
        self.beats = beats
        self.service = list(service_ids)
        self.quiet = set()
        self.failing = set()
        self.reports = Counter()

    def sync(self, nodes=(), jobs=()):
        from nomad_tpu_torch.structs import enums

        snap = self.srv.store.snapshot()
        seen, run, fail, done = set(), [], [], []
        pool = [a for j in list(self.service) + list(jobs)
                for a in snap.allocs_by_job(j)]
        pool += [a for n in nodes for a in snap.allocs_by_node(n)]
        for a in pool:
            if a.id in seen or a.node_id in self.beats.silent:
                continue
            seen.add(a.id)
            if a.client_terminal():
                continue
            if a.server_terminal():
                done.append(a)
            elif a.client_status == enums.ALLOC_CLIENT_PENDING:
                if a.job_id in self.failing and a.canary:
                    fail.append(a)
                elif a.job_id not in self.quiet and a.job_id in self.service:
                    run.append(a)
        if run:
            lc_client(self.srv, run, enums.ALLOC_CLIENT_RUNNING,
                      deployment_status={"healthy": True})
        if fail:
            lc_client(self.srv, fail, enums.ALLOC_CLIENT_FAILED,
                      task_finished_at=time.time())
        if done:
            lc_client(self.srv, done, enums.ALLOC_CLIENT_COMPLETE,
                      task_finished_at=time.time())
        self.reports.update(running=len(run), failed=len(fail),
                            complete=len(done))
        return len(run) + len(fail) + len(done)


def ap_until(clients, pred, what, timeout, sample=None, **sync):
    """Play the clients until ``pred()`` holds, within ``timeout`` s; on
    a timeout, the service jobs' deployments that did not succeed.
    ``sample()``, when given, reads the store before each round of the
    clients' reports."""
    deadline = time.time() + timeout
    while True:
        if sample is not None:
            sample()
        clients.sync(**sync)
        if pred():
            return
        if time.time() > deadline:
            raise AssertionError(f"autopilot {what}: not reached in "
                                 f"{timeout:.0f} s; deployments: "
                                 f"{ap_dep_report(clients)}")
        clients.srv.wait_for_idle(0.25, include_delayed=False)


def ap_gates(srv, beats, what) -> dict:
    """No node that kept heartbeating marked down (its status now, and
    every expiry the manager logged), and no single-writer volume with
    more than one live writer claim."""
    snap = srv.store.snapshot()
    down = {n.id for n in snap.nodes() if n.status in ("down",
                                                       "disconnected")}
    expired = {nid for nid, _, _ in srv.heartbeats.expiry_snapshot()}
    false = (down | expired) - beats.silent
    if false:
        raise AssertionError(f"autopilot {what}: {len(false)} nodes that "
                             f"kept heartbeating marked down: "
                             f"{sorted(false)[:4]}")
    for vol in snap.volumes():
        if vol.access_mode != "single-node-writer":
            continue
        live = [c for c in vol.writers()
                if (a := snap.alloc_by_id(c.alloc_id)) is not None
                and not a.terminal_status()]
        if len(live) > 1:
            raise AssertionError(f"autopilot {what}: volume {vol.id} has "
                                 f"{len(live)} live writers")
    return {"false_mark_downs": len(false), "down": len(down)}


def ap_drain_nodes(srv, n, n_paced, exclude, paced):
    """``n`` loaded nodes to drain. First ``n_paced`` nodes that hold a
    group of three or more allocs of the ``paced`` jobs (which migrate
    AP_MIGRATE at a time, the others one), where max_parallel binds: the
    fewest rounds first, at most AP_DRAIN_PACED_ROUNDS. Then, of the
    nodes that no group needs more than AP_DRAIN_ROUNDS rounds to leave,
    those with the most allocs of the paced jobs in such groups, then
    the fewest rounds, then the most allocs; when too few nodes are that
    quick to leave (the layout varies by call), the rest by the fewest
    rounds up to AP_DRAIN_PACED_ROUNDS, the paced nodes' bound, so the
    slowest node's drain stays within it. Ties by node id. Raises when
    too few nodes qualify."""
    per = {}
    for a in srv.store.snapshot().allocs():
        if not a.terminal_status() and a.node_id not in exclude:
            per.setdefault(a.node_id, Counter())[a.job_id] += 1

    def rounds(nid):
        return max(-(-v // (AP_MIGRATE if j in paced else 1))
                   for j, v in per[nid].items())

    def rank(nid):
        c = per[nid]
        bound = sum(v for j, v in c.items() if j in paced and v > 2)
        return (-bound, rounds(nid), -sum(c.values()), nid)
    bound = sorted((nid for nid in per if rank(nid)[0] < 0
                    and rounds(nid) <= AP_DRAIN_PACED_ROUNDS),
                   key=lambda nid: (rounds(nid), -sum(per[nid].values()),
                                    nid))[:n_paced]
    fits = [nid for nid in per if rounds(nid) <= AP_DRAIN_ROUNDS
            and nid not in bound]
    rest = sorted(fits, key=rank)[:n - len(bound)]
    if len(bound) + len(rest) < n:
        slow = sorted((nid for nid in per if nid not in bound
                       and AP_DRAIN_ROUNDS < rounds(nid)
                       <= AP_DRAIN_PACED_ROUNDS),
                      key=lambda nid: (rounds(nid), -sum(per[nid].values()),
                                       nid))
        rest += slow[:n - len(bound) - len(rest)]
    if len(bound) < n_paced or len(bound) + len(rest) < n:
        raise AssertionError(f"autopilot drain: {len(bound)} nodes with a "
                             f"paced group of three or more within "
                             f"{AP_DRAIN_PACED_ROUNDS} rounds (want "
                             f"{n_paced}), {len(rest)} others within "
                             f"{AP_DRAIN_PACED_ROUNDS}")
    return bound + rest


def ap_dep_report(clients) -> list:
    """Each service job whose latest deployment is not successful: its
    version, its deployments (version, status, description) and its
    allocs by version, client and desired status, canary flag and
    whether the latest deployment holds them; its last five evals."""
    snap = clients.srv.store.snapshot()
    out = []
    for j in clients.service:
        d = snap.latest_deployment_by_job(j)
        if (d is None and snap.job_by_id(j).task_groups[0].update is None
                or d is not None and d.status == "successful"):
            continue
        allocs = snap.allocs_by_job(j)
        seen = Counter((a.job_version, a.client_status, a.desired_status,
                        a.canary, d is not None and a.deployment_id == d.id)
                       for a in allocs)
        evals = [(e.triggered_by, e.status, e.wait_until > 0)
                 for e in snap.evals_by_job(j)][-5:]
        deps = [(x.job_version, x.status, x.status_description)
                for x in sorted(snap.deployments_by_job(j),
                                key=lambda x: x.create_index)]
        out.append((j, snap.job_by_id(j).version, deps, dict(seen), evals))
    return out[:4]


def ap_unlinked(srv, preds) -> int:
    """The predecessors no alloc names as previous_allocation. A
    replacement that lands on a node another shard's expiry (or a drain)
    takes down at the same moment is rejected by the applier after the
    predecessor's stop committed; the retry's count math places it with
    no link, in the reference as in the port. The walk's live counts
    hold either way."""
    snap = srv.store.snapshot()
    named = {a.previous_allocation for a in snap.allocs()
             if a.previous_allocation}
    return sum(1 for p in preds if p.id not in named)


def ap_deps(srv, job_ids):
    """The latest deployment of each job."""
    snap = srv.store.snapshot()
    return {j: snap.latest_deployment_by_job(j) for j in job_ids}


def ap_inflight(srv, node_ids, max_par) -> dict:
    """Per (node, job, group) on the draining nodes: allocs marked to
    migrate or stopped whose client has not reported them terminal; a
    gate that none is past its group's max_parallel. Returns the peak a
    group's max_parallel."""
    snap = srv.store.snapshot()
    peak = Counter()
    for nid in node_ids:
        flight = Counter()
        why = {}
        for a in snap.allocs_by_node(nid):
            if a.client_terminal():
                continue
            if a.desired_transition.migrate or a.server_terminal():
                key = (a.job_id, a.task_group)
                flight[key] += 1
                why.setdefault(key, Counter())[
                    a.desired_description or a.desired_status] += 1
        for key, n in flight.items():
            cap = max_par.get(key[0], 1)
            if n > cap:
                raise AssertionError(f"autopilot drain: {n} allocs of "
                                     f"{key} in flight on {nid}, "
                                     f"max_parallel {cap}: "
                                     f"{dict(why[key])}")
            peak[cap] = max(peak[cap], n)
    return dict(peak)


def phase_autopilot(torch, card, device="cuda", n_nodes=N_NODES,
                    scale=1.0):
    """The lifecycle on its own (ROADMAP A27, A5b) through the port's
    Server under "tpu-binpack", 24 workers, the feed on, every actor
    running: heartbeats with an AP_TTL TTL (a thread of the phase heartbeats
    every live node through heartbeat_batch), the deployment watcher,
    the drainer and core GC (gc_interval 3,600 s: it runs when the phase
    calls force_gc). C2M's nodes with network modes, host volumes and
    four CSI zones; the phase plays the clients. Six steps: silence,
    drain, auto-promote, auto-revert, progress deadline, GC with node
    delete and a B1 refill. ``scale`` shrinks the job sizes (a CPU
    rehearsal). Returns (the launch counts of the steps, the record)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import DrainStrategy, Volume, VolumeRequest
    from nomad_tpu_torch.structs.job import MigrateStrategy, UpdateStrategy
    from nomad_tpu_torch.structs.resources import NetworkResource
    from nomad_tpu_torch.tensor import incremental, kernels
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)
    from nomad_tpu_torch.tensor.solver import get_service

    def sized(n):
        return max(1, int(round(n * scale)))

    lc = Lifecycle(card, device, SERVER_WORKERS, actors=True,
                   name="autopilot", heartbeat_ttl=AP_TTL)
    srv = lc.srv
    nodes = ap_nodes(n_nodes)
    srv.store.upsert_nodes(nodes)
    zones = [[n.id for n in nodes[z::4]] for z in range(4)]
    k_batch, k_svc = sized(AP_BATCH_K), sized(AP_SVC_K)

    def svc(tag, count, **kw):
        j = mock.service_job(count, cpu=100, mem=64)
        j.id = j.name = tag
        tg = j.task_groups[0]
        tg.update = UpdateStrategy(max_parallel=sized(AP_ROLL),
                                   min_healthy_time_s=0.0)
        tg.migrate = MigrateStrategy(max_parallel=AP_MIGRATE)
        for key, v in kw.items():
            setattr(tg, key, v)
        return j

    batch = []
    for i in range(AP_BATCH_JOBS):
        j = mock.service_job(k_batch, cpu=50, mem=32, batch=True)
        j.id = j.name = f"ap-batch-{i:02d}"
        batch.append(j)
    vol = [svc(f"ap-vol-{i}", k_svc, volumes={"data": VolumeRequest(
        name="data", type="host", source="data")})
        for i in range(AP_VOL_JOBS)]
    # no update stanza: a group the bulk path places opens no deployment
    # (as the reference's generic_sched.py:152), and one whose plan the
    # applier rejects in part would open one for the remainder alone
    bridge = [svc(f"ap-bridge-{i}", k_svc, update=None,
                  networks=[NetworkResource(mode="bridge")])
              for i in range(AP_BRIDGE_JOBS)]
    cni = [svc(f"ap-cni-{i}", k_svc, update=None,
               networks=[NetworkResource(mode="cni/calico")])
           for i in range(AP_CNI_JOBS)]
    csi = [svc(f"ap-csi-{i}", 1, volumes={"db": VolumeRequest(
        name="db", type="csi", source=f"ap-db-{i}")})
        for i in range(AP_CSI_JOBS)]
    reader = svc("ap-reader", sized(AP_READER_K), volumes={
        "shared": VolumeRequest(name="shared", type="csi",
                                source="ap-shared", read_only=True,
                                access_mode="multi-node-reader-only")})
    service = vol + bridge + cni + csi + [reader]
    rolled = [j.id for j in service if j.task_groups[0].update is not None]
    beats = Beats(srv, [n.id for n in nodes])
    clients = Clients(srv, beats, [j.id for j in service])
    max_par = {j.id: AP_MIGRATE for j in service}
    t_setup = time.perf_counter()
    _ext.COUNTS.reset()
    with incr_arm("1"), srv, lc.capture(), beats:
        for i in range(AP_CSI_JOBS):
            srv.register_volume(Volume(id=f"ap-db-{i}", name=f"ap-db-{i}",
                                       topology_node_ids=zones[i % 4]))
        srv.register_volume(Volume(id="ap-shared", name="ap-shared",
                                   access_mode="multi-node-reader-only"))
        for j in batch + service:
            srv.register_job(j)
            lc.desired[j.id] = j.task_groups[0].count
        lc.idle("fill")
        ap_until(clients, lambda: all(
            d is not None and d.status == "successful"
            for d in ap_deps(srv, rolled).values()),
            "fill deployments", 120.0)
        lc.walk("fill")
        ap_gates(srv, beats, "fill")
        fill_s = time.perf_counter() - t_setup
        snap = srv.store.snapshot()
        on = {a.node_id for a in snap.allocs() if not a.terminal_status()}
        modes_ok = all(
            ("network.bridge" in snap.node_by_id(a.node_id).attributes)
            for j in bridge for a in snap.allocs_by_job(j.id)) and all(
            ("plugins.cni.version.calico" in snap.node_by_id(
                a.node_id).attributes)
            for j in cni for a in snap.allocs_by_job(j.id)) and all(
            not getattr(snap.node_by_id(a.node_id).host_volumes.get(
                "data"), "read_only", True)
            for j in vol for a in snap.allocs_by_job(j.id))
        if not modes_ok:
            raise AssertionError("autopilot fill: a bridge, CNI or host-"
                                 "volume alloc on a node without it")
        for i, j in enumerate(csi):
            (a,) = [a for a in snap.allocs_by_job(j.id)
                    if not a.terminal_status()]
            if a.node_id not in zones[i % 4]:
                raise AssertionError(f"autopilot fill: {j.id} outside its "
                                     f"volume's zone")
        snap.close()  # a snapshot held open pins the compaction
        print(f"autopilot   setup and fill {fill_s:.2f} s ({n_nodes} nodes, "
              f"{len(batch) + len(service)} jobs, "
              f"{sum(lc.desired.values())} allocs on {len(on)} nodes, "
              f"{SERVER_WORKERS} workers, heartbeat_ttl {AP_TTL} s)")
        feed = incremental.feed_for(srv.store)
        # 1. silence: nodes stop heartbeating, one with a CSI writer
        csi0 = [a for a in srv.store.snapshot().allocs_by_job(csi[0].id)
                if not a.terminal_status()][0]
        held = {a.node_id for j in csi[1:] for a in
                srv.store.snapshot().allocs_by_job(j.id)}
        silent = [csi0.node_id] + lc_loaded(
            srv, sized(AP_SILENT) - 1, exclude=held | {csi0.node_id})
        lost = lc_live_on(srv, silent)

        def step_silence():
            f0 = dict(feed.stats(), node_set=srv.store.node_set_version)
            t0 = time.monotonic()
            beats.silence(silent)

            def all_lost():
                # the mark's evals are enqueued after its status write:
                # wait for their plans too (no live alloc left there)
                snap = srv.store.snapshot()
                return (all(snap.node_by_id(n).status == "down"
                            for n in silent)
                        and not lc_live_on(srv, silent))
            ap_until(clients, all_lost, "silence", 4 * AP_TTL + 30.0)
            marked_s = time.monotonic() - t0
            lc.gone.update(silent)
            lc.idle("silence")
            clients.sync()
            unlinked = ap_unlinked(srv, lost)
            snap = srv.store.snapshot()
            down = {n.id for n in snap.nodes() if n.status == "down"}
            if down != set(silent):
                raise AssertionError(f"autopilot silence: {len(down)} "
                                     f"nodes down, want exactly the "
                                     f"{len(silent)} silenced")
            vol0 = snap.volume_by_id("ap-db-0")
            writers = [c for c in vol0.writers()
                       if not snap.alloc_by_id(c.alloc_id)
                       .terminal_status()]
            if (len(writers) != 1
                    or writers[0].node_id not in zones[0]
                    or writers[0].node_id == csi0.node_id):
                raise AssertionError(f"autopilot silence: volume "
                                     f"ap-db-0's live writers "
                                     f"{writers}")
            out = ap_gates(srv, beats, "silence")
            out.update(nodes=len(silent), lost=len(lost),
                       unlinked=unlinked, marked_after_s=marked_s,
                       feed=feed_delta(srv.store, f0, feed.stats()))
            return out
        lc.step("silence", step_silence)

        # 2. drain: nodes drained with a deadline, the drainer pacing
        # by migrate.max_parallel, the clients acking
        drained = ap_drain_nodes(srv, sized(AP_DRAIN), sized(AP_DRAIN_PACED),
                                 lc.gone, {j.id for j in service})
        moved = lc_live_on(srv, drained)

        def step_drain():
            f0 = dict(feed.stats(), node_set=srv.store.node_set_version)
            done0 = srv.drainer.stats["drains_completed"]
            for nid in drained:
                srv.update_node_drain(nid, DrainStrategy(
                    deadline_s=AP_DRAIN_DEADLINE))
            t0 = time.time()
            peak, samples = Counter(), 0

            def in_flight():
                # before the clients ack: what the drainer marked and the
                # scheduler stopped since the last round is still there
                nonlocal samples
                samples += 1
                for cap, n in ap_inflight(srv, drained,
                                          max_par).items():
                    peak[cap] = max(peak[cap], n)

            def drains_done():
                snap = srv.store.snapshot()
                return not any(snap.node_by_id(n).drain
                               for n in drained)
            ap_until(clients, drains_done, "drain",
                     AP_DRAIN_DEADLINE - 2.0, sample=in_flight,
                     nodes=drained)
            drain_s = time.time() - t0
            lc.gone.update(drained)
            lc.idle("drain")
            clients.sync(nodes=drained)
            unlinked = ap_unlinked(srv, moved)
            snap = srv.store.snapshot()
            if any(snap.node_by_id(n).scheduling_eligibility
                   != "ineligible" for n in drained):
                raise AssertionError("autopilot drain: a drained node "
                                     "is eligible again")
            done = srv.drainer.stats["drains_completed"] - done0
            if done != len(drained):
                raise AssertionError(f"autopilot drain: {done} drains "
                                     f"completed, want {len(drained)}")
            if peak.get(AP_MIGRATE) != AP_MIGRATE:
                raise AssertionError(f"autopilot drain: the paced groups' "
                                     f"peak in flight {dict(peak)} in "
                                     f"{samples} samples, want "
                                     f"{AP_MIGRATE} (max_parallel)")
            out = ap_gates(srv, beats, "drain")
            out.update(nodes=len(drained), migrated=len(moved),
                       unlinked=unlinked, drain_s=drain_s, samples=samples,
                       peak_inflight=dict(peak), completed=done,
                       marked=srv.drainer.stats["migrations_marked"],
                       feed=feed_delta(srv.store, f0, feed.stats()))
            return out
        lc.step("drain", step_drain)

        def update(jobs, tag, **strategy):
            new = []
            for j in jobs:
                j2 = copy.deepcopy(srv.store.snapshot().job_by_id(j.id))
                j2.task_groups[0].tasks[0].config = {"command": tag}
                j2.task_groups[0].update = UpdateStrategy(
                    max_parallel=sized(AP_ROLL), min_healthy_time_s=0.0,
                    **strategy)
                srv.register_job(j2)
                new.append(srv.store.snapshot().job_by_id(j.id).version)
            return new

        # 3. auto-promote: canaries reported healthy, the watcher
        # promotes them and the rollout succeeds
        pjobs = vol[:AP_PROMOTE_JOBS]

        def step_promote():
            f0 = dict(feed.stats(), node_set=srv.store.node_set_version)
            versions = update(pjobs, "/bin/v2", canary=AP_CANARY,
                              auto_promote=True)
            ids = [j.id for j in pjobs]

            def succeeded():
                deps = ap_deps(srv, ids)
                return all(d.job_version == v and d.status ==
                           "successful" for d, v in
                           zip(deps.values(), versions))
            ap_until(clients, succeeded, "auto-promote", 120.0)
            lc.idle("auto-promote")
            deps = ap_deps(srv, ids)
            if not all(s.promoted for d in deps.values()
                       for s in d.task_groups.values()):
                raise AssertionError("autopilot auto-promote: a group "
                                     "not promoted")
            out = lc_versions(srv, pjobs, "auto-promote")
            out.update(ap_gates(srv, beats, "auto-promote"))
            out.update(versions=versions, auto_promoted=srv.
                       deployment_watcher.stats["auto_promoted"],
                       feed=feed_delta(srv.store, f0, feed.stats()))
            return out
        lc.step("auto-promote", step_promote)

        # 4. auto-revert: the canaries of a bad update fail, the
        # watcher fails the deployment and registers the prior version
        rjobs = vol[AP_PROMOTE_JOBS:AP_PROMOTE_JOBS + AP_REVERT_JOBS]

        def step_revert():
            before = {j.id: srv.store.snapshot().job_by_id(j.id)
                      for j in rjobs}
            clients.failing.update(j.id for j in rjobs)
            reverts0 = srv.deployment_watcher.stats["reverted"]
            bad = update(rjobs, "/bin/bad", canary=1, auto_revert=True)
            ids = [j.id for j in rjobs]

            def bad_deps(snap):
                return [d for j, v in zip(ids, bad)
                        for d in snap.deployments_by_job(j)
                        if d.job_version == v]

            def reverted():
                # the watcher failed each bad deployment and registered
                # the prior version; a canary plan scheduled before the
                # failure may write the deployment back as running, and
                # the watcher then cancels it as superseded (the
                # reference's race, ROADMAP §C5). The revert's eval may
                # be cancelled by a newer eval of the job: wait for the
                # live allocs instead
                snap = srv.store.snapshot()
                if (srv.deployment_watcher.stats["reverted"] - reverts0
                        < len(ids)
                        or any(d.active() for d in bad_deps(snap))):
                    return False
                for j, v in zip(ids, bad):
                    if snap.job_by_id(j).version != v + 1:
                        return False
                    live = Counter(a.job_version
                                   for a in snap.allocs_by_job(j)
                                   if not a.terminal_status())
                    if live != {v + 1: lc.desired[j]}:
                        return False
                return True
            ap_until(clients, reverted, "auto-revert", 60.0)
            clients.failing.clear()
            lc.idle("auto-revert")
            clients.sync()
            snap = srv.store.snapshot()
            live = {j: dict(Counter(
                a.job_version for a in snap.allocs_by_job(j)
                if not a.terminal_status())) for j in ids}
            for j, v in zip(ids, bad):
                cur = snap.job_by_id(j)
                if (cur.task_groups[0].tasks[0].config
                        != before[j].task_groups[0].tasks[0].config):
                    raise AssertionError(f"autopilot auto-revert: {j} "
                                         f"not back on its prior spec")
                if live[j] != {v + 1: lc.desired[j]}:
                    raise AssertionError(f"autopilot auto-revert: {j}'s "
                                         f"live allocs by version "
                                         f"{live[j]}, want {lc.desired[j]} "
                                         f"on version {v + 1}")
            statuses = [d.status for d in bad_deps(snap)]
            if len(statuses) != len(ids) or not set(statuses) <= {
                    "failed", "cancelled"}:
                raise AssertionError(f"autopilot auto-revert: the bad "
                                     f"deployments' statuses {statuses}")
            out = ap_gates(srv, beats, "auto-revert")
            out.update(bad_versions=bad, reverted=srv.
                       deployment_watcher.stats["reverted"] - reverts0,
                       bad_deployments=dict(Counter(statuses)),
                       live_by_version=live)
            return out
        lc.step("auto-revert", step_revert)

        # 5. progress deadline: no health report, the watcher fails it
        djob = vol[AP_PROMOTE_JOBS + AP_REVERT_JOBS]

        def step_deadline():
            clients.quiet.add(djob.id)
            (v,) = update([djob], "/bin/slow",
                          progress_deadline_s=AP_DEADLINE)
            t0 = time.time()

            def failed():
                d = ap_deps(srv, [djob.id])[djob.id]
                return (d.job_version == v and d.status == "failed"
                        and "deadline" in d.status_description)
            ap_until(clients, failed, "progress deadline",
                     AP_DEADLINE + 30.0)
            lc.idle("progress deadline")
            out = ap_gates(srv, beats, "progress deadline")
            out.update(failed_after_s=time.time() - t0, version=v)
            return out
        lc.step("deadline", step_deadline)

        # 6. GC: deregistered batch jobs completed, force_gc drops
        # their allocs (block positions too), the dead jobs and evals,
        # the down nodes and stale claims; then a B1 refill
        gjobs = batch[:AP_GC_JOBS]
        fresh = []
        for i in range(AP_NEW_JOBS):
            j = mock.service_job(k_batch, cpu=50, mem=32, batch=True)
            j.id = j.name = f"ap-refill-{i}"
            fresh.append(j)

        def step_gc():
            f0 = dict(feed.stats(), node_set=srv.store.node_set_version)
            for j in gjobs:
                srv.deregister_job(j.id)
                lc.desired.pop(j.id)
            lc.idle("gc deregister")
            clients.sync(jobs=[j.id for j in gjobs])
            blocks = {b.id for b in srv.store.snapshot().alloc_blocks()
                      if b.job_id in {j.id for j in gjobs}}
            t0 = time.perf_counter()
            stats = srv.force_gc()
            gc_s = time.perf_counter() - t0
            snap = srv.store.snapshot()
            left = [j.id for j in gjobs
                    if snap.job_by_id(j.id) is not None
                    or snap.allocs_by_job(j.id)
                    or snap.evals_by_job(j.id)]
            if left or any(snap.alloc_block_by_id(b) for b in blocks):
                raise AssertionError(f"autopilot gc: jobs, allocs, evals "
                                     f"or blocks left: {left[:4]}")
            if any(snap.node_by_id(n) is not None for n in silent):
                raise AssertionError("autopilot gc: a down node not "
                                     "deleted")
            stale = [c for v in snap.volumes() for c in v.claims.values()
                     if (a := snap.alloc_by_id(c.alloc_id)) is None
                     or a.terminal_status()]
            if stale or stats["volume_claims"] < 1:
                raise AssertionError(f"autopilot gc: {len(stale)} stale "
                                     f"claims, {stats['volume_claims']} "
                                     f"released")
            if not feed.force_verify():
                raise AssertionError(
                    f"autopilot gc: the feed's verify failed: "
                    f"{incremental.GLOBAL.violations[-1:]}")
            lc.gone.difference_update(silent)
            for j in fresh:
                srv.register_job(j)
                lc.desired[j.id] = k_batch
            lc.idle("gc refill")
            out = ap_gates(srv, beats, "gc")
            out.update(gc_s=gc_s, blocks_dropped=len(blocks),
                       gc={k: stats[k] for k in (
                           "evals", "allocs", "jobs", "deployments",
                           "nodes", "volume_claims", "rows_compacted")},
                       feed=feed_delta(srv.store, f0, feed.stats()))
            return out
        lc.step("gc", step_gc)
        counts = _ext.COUNTS.snapshot()
        verified = feed.force_verify()
        feed_stats = feed.stats()
        blocked = srv.blocked.blocked_count()
    hb = beats.report()
    gates = ap_gates(srv, beats, "end")
    expiries = srv.heartbeats.expiry_snapshot()
    hb_stats = dict(srv.heartbeats.stats)
    watcher = dict(srv.deployment_watcher.stats)
    drainer = dict(srv.drainer.stats)
    if beats.errors:
        raise AssertionError(f"autopilot: heartbeats refused: "
                             f"{beats.errors[:2]}")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"autopilot: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    if not verified or blocked:
        raise AssertionError(f"autopilot: the feed's verify "
                             f"{'passed' if verified else 'failed'}, "
                             f"{blocked} evals blocked")
    launched = counts["launches"]
    if not lc.b1 or not lc.b9:
        raise AssertionError(f"autopilot: B1 {len(lc.b1)} and B9 "
                             f"{len(lc.b9)} launches captured")
    err = 0.0
    for i, (packed, out, _) in enumerate(lc.b9):
        got = kernels.solve_task_group_fused(*packed)
        want = kernels.solve_task_group_fused_ref(*packed)
        if not (torch.equal(got[:2], want[:2]) and torch.equal(got, out)):
            raise AssertionError(f"autopilot: B9 launch {i} differs from "
                                 f"its plain version or the path's output")
        err = max(err, score_err(got[2], want[2], f"autopilot B9 {i}"))
    for i, (before, args, g, used, cnt, _) in enumerate(lc.b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"autopilot: B1 launch {i} differs from "
                                 f"its plain version or the path's output")
    for i, (args, kw, out, _) in enumerate(lc.b11):
        got = kernels.solve_bulk(*args, **kw)
        want = kernels.solve_bulk_ref(*args, **kw)
        if not (torch.equal(got, want) and torch.equal(got, out)):
            raise AssertionError(f"autopilot: B11 launch {i} differs from "
                                 f"its plain version or the path's output")
    b9_steps = Counter(c[2] for c in lc.b9)
    b1_steps = Counter(c[5] for c in lc.b1)
    rec = {"nodes": n_nodes, "heartbeat_ttl": AP_TTL, "fill_s": fill_s,
           "steps": lc.steps, "b9_launches_by_step": dict(b9_steps),
           "b1_launches_by_step": dict(b1_steps), "b9_max_score_err": err,
           "b11_launches_by_step": dict(Counter(c[3] for c in lc.b11)),
           "heartbeats": hb, "expiries": len(expiries),
           "heartbeat_stats": hb_stats, "watcher": watcher,
           "drainer": drainer, "clients": dict(clients.reports),
           "feed": feed_stats, "gates": gates,
           "launches": {k: v for k, v in launched.items() if v},
           "card": card}
    for s in lc.steps:
        print(f"autopilot   [{card}] {s['step']}: wall {s['wall_s']:.3f} s; "
              f"B9 {s['launches'].get('solve_task_group', 0)}, B1 "
              f"{s['launches'].get('bulk_fill', 0)}, B4 "
              f"{s['launches'].get('scatter_add', 0)} launches; "
              f"nodes_rejected {s['nodes_rejected']}; span p50 ms "
              + "; ".join(f"{n} {v['p50_ms']:.3f} ({v['n']})"
                          for n, v in s["spans"].items()))
    print(f"autopilot   [{card}] B9 {len(lc.b9)} launches by step "
          f"{dict(b9_steps)}, B1 {len(lc.b1)} by step {dict(b1_steps)}, "
          f"B11 {len(lc.b11)} (the reader's CSI group: its mask per eval): "
          f"replays exact (B9 scores within {SCORE_TOL}, max {err:.3g}); "
          f"heartbeats {hb}; expiries {len(expiries)} (all silenced); "
          f"watcher {watcher}; drainer {drainer}; feed {feed_stats}")
    get_service(device).stop()
    return launched, rec


def feed_delta(store, before, after) -> dict:
    """The feed's resyncs, twin uploads and flushes between two stats,
    beside the node writes that bumped the store's node set (each
    makes a new static)."""
    out = {k: after[k] - before[k] for k in ("resyncs", "twin_uploads",
                                             "twin_flushes", "builds")}
    out["node_writes"] = store.node_set_version - before["node_set"]
    return out


def _drain(srv, what, limit=600.0):
    """Drain a Server's queue, conflict-blocked evals included."""
    deadline = time.time() + limit
    while True:
        if not srv.wait_for_idle(max(1.0, deadline - time.time()),
                                 include_delayed=False):
            raise AssertionError(f"{what}: the eval queue did not drain: "
                                 f"{blocked_report(srv)}")
        if srv.blocked.blocked_count() == 0:
            return
        if time.time() > deadline:
            raise AssertionError(f"{what}: blocked evals did not drain: "
                                 f"{blocked_report(srv)}")
        time.sleep(0.05)


def _gc_watch(pauses):
    """A gc callback appending each collection's generation and seconds
    to ``pauses``."""
    start = [0.0]

    def cb(phase, info):
        if phase == "start":
            start[0] = time.perf_counter()
        else:
            pauses.append((info["generation"],
                           time.perf_counter() - start[0]))
    return cb


def _on_leader(cluster, fn, retries, what):
    """``fn(leader)`` on the cluster's leader, again on the next leader
    when leadership moves under the call (a client's retry); each retry
    is counted in ``retries``."""
    from nomad_tpu_torch.raft import NotLeaderError

    for _ in range(5):
        leader = cluster.wait_for_leader(60.0)
        if leader is None:
            raise AssertionError(f"{what}: no leader")
        try:
            return fn(leader)
        except (NotLeaderError, TimeoutError):
            retries[what] = retries.get(what, 0) + 1
    raise AssertionError(f"{what}: leadership moved five times")


def _drain_cluster(cluster, what, limit=600.0):
    """Drain the leader's queue; again on a new leader if leadership
    moved meanwhile. Returns the leader."""
    deadline = time.time() + limit
    while True:
        leader = cluster.wait_for_leader(max(1.0, deadline - time.time()))
        if leader is None:
            raise AssertionError(f"{what}: no leader")
        _drain(leader.server, what, max(1.0, deadline - time.time()))
        if cluster.leader() is leader:
            return leader


def _committed_jobs(store, jobs, k) -> int:
    """Jobs whose k allocs the store holds live."""
    snap = store.snapshot()
    try:
        return sum(1 for j in jobs
                   if sum(1 for a in snap.allocs_by_job(j.id)
                          if not a.terminal_status()) == k)
    finally:
        snap.close()


def _over_capacity(store) -> int:
    """Nodes whose usage rows exceed their capacity."""
    snap = store.snapshot()
    try:
        over = 0
        for n in snap.nodes():
            u = snap.node_usage(n.id)
            if u is not None and (np.asarray(u) > n.available_vec()).any():
                over += 1
        return over
    finally:
        snap.close()


class _Nodes(list):
    """A node sink for mock.build_nodes: the phase registers them through
    the Server or the cluster."""

    upsert_node = list.append


def phase_replicated(torch, card, device="cuda", n_nodes=N_NODES,
                     n_jobs=REPL_JOBS, k=K, workers=SERVER_WORKERS,
                     crash_at=REPL_CRASH_AT, snapshot_threshold=REPL_SNAPSHOT,
                     server_rec=None):
    """The replicated control plane (see the module docstring): returns
    the launch counts of its run and its record. ``server_rec`` is the
    "server" phase's record, printed beside the waves."""
    import shutil

    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.core.server import ServerConfig
    from nomad_tpu_torch.obs import RECORDER, REGISTRY, TRACER
    from nomad_tpu_torch.obs.trace import R_ARGS, R_NAME, R_T0
    from nomad_tpu_torch.raft import RaftCluster
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.state.persist import dump_store, restore_store
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import incremental, solver
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)
    from nomad_tpu_torch.testing import replica_fingerprint

    what = "replicated"
    tpu = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)

    def cfg(i):
        return ServerConfig(
            num_workers=workers, eval_batch_size=1, device=device,
            sched_config=tpu, nack_timeout=900.0,
            failed_eval_followup_delay=3600.0,
            failed_eval_unblock_interval=0.5, **BENCH_SAFE)

    data = REPO / "build" / f"replicated-{os.getpid()}"
    shutil.rmtree(data, ignore_errors=True)
    data.mkdir(parents=True)
    RECORDER.clear()
    t_setup = time.perf_counter()
    cluster = RaftCluster(3, config_fn=cfg, data_dir=str(data),
                          snapshot_threshold=snapshot_threshold,
                          election_timeout=REPL_ELECTION_TIMEOUT,
                          heartbeat_interval=REPL_HEARTBEAT)
    pauses = []
    watch = _gc_watch(pauses)
    gc.callbacks.append(watch)
    b1, b4 = [], []
    try:
        cluster.start()
        leader = cluster.wait_for_leader(30.0)
        if leader is None:
            raise AssertionError(f"{what}: no leader elected")
        retries = {}
        nodes = _Nodes()
        mock.build_nodes(nodes, n_nodes, seed=0)
        t0 = time.perf_counter()
        _on_leader(cluster, lambda ld: ld.register_nodes(list(nodes)),
                   retries, "register_nodes")
        nodes_s = time.perf_counter() - t0
        _on_leader(cluster, lambda ld: ld.set_scheduler_config(tpu),
                   retries, "set_scheduler_config")
        warm = mock.service_job(k, cpu=50, mem=32, batch=True)
        _on_leader(cluster, lambda ld: ld.register_job(warm), retries,
                   "register_job")
        _drain_cluster(cluster, f"{what} warm-up")
        _on_leader(cluster, lambda ld: ld.deregister_job(warm.id), retries,
                   "deregister_job")
        leader = _drain_cluster(cluster, f"{what} warm-up stop")
        waves = [[mock.service_job(k, cpu=50, mem=32, batch=True)
                  for _ in range(n_jobs)] for _ in range(2)]
        print(f"{what:<11} setup and warm-up "
              f"{time.perf_counter() - t_setup:.2f} s (3 servers, "
              f"{n_nodes} nodes as one upsert_nodes in {nodes_s:.2f} s, "
              f"2 waves of {n_jobs} jobs x {k} allocs, {workers} workers "
              f"on the leader, a snapshot every {snapshot_threshold} "
              f"applied entries)")

        # every B1 launch's inputs and outputs, tagged with the leader
        # whose Server was serving (the crashed one's until the new one
        # serves: the start gate orders them)
        real_b1 = solver.solve_bulk_multi
        last = [leader.id]

        def captured_b1(used, *args, g):
            serving = [sv.id for sv in cluster.servers.values()
                       if sv._serving]
            if serving:
                last[0] = serving[0]
            before = used.clone()
            keep = [a.clone() for a in args]
            out = real_b1(used, *args, g=g)
            b1.append((before, keep, g, out[0].clone(), out[1].clone(),
                       last[0]))
            return out

        TRACER.clear()
        REGISTRY.reset()
        solver.solve_bulk_multi = captured_b1
        first_id = leader.id
        terms0 = {sid: sv.raft.current_term
                  for sid, sv in cluster.servers.items()}
        try:
            with capture_b4(b4):
                _ext.COUNTS.reset()
                t_wall = time.time()
                # wave 1
                t0 = time.perf_counter()
                for j in waves[0]:
                    _on_leader(cluster, lambda ld, j=j: ld.register_job(j),
                               retries, "register_job")
                leader = _drain_cluster(cluster, f"{what} wave 1")
                walls = [time.perf_counter() - t0]
                stats1 = dict(leader.server.plan_applier.stats)
                # every server snapshotted before the crash
                deadline = time.time() + 120.0
                while not all(sv.raft.log.base_index > 0
                              for sv in cluster.servers.values()):
                    if time.time() > deadline:
                        raise AssertionError(
                            f"{what}: not every server snapshotted before "
                            f"the crash: " + str({
                                sid: sv.raft.log.base_index
                                for sid, sv in cluster.servers.items()}))
                    time.sleep(0.05)
                snaps_before = {sid: sv.raft.log.base_index
                                for sid, sv in cluster.servers.items()}
                # wave 2, the leader crashed in its middle: half its jobs
                # registered before the crash (the old leader solves them
                # all before the first commits land), half after it
                half = n_jobs // 2
                t0 = time.perf_counter()
                for j in waves[1][:half]:
                    _on_leader(cluster, lambda ld, j=j: ld.register_job(j),
                               retries, "register_job")
                leader = cluster.wait_for_leader(60.0)
                deadline = time.time() + 300.0
                while True:
                    done = _committed_jobs(leader.local_store,
                                           waves[1][:half], k)
                    if done >= crash_at:
                        break
                    if time.time() > deadline:
                        raise AssertionError(f"{what}: {done} of wave 2's "
                                             f"jobs committed in 300 s")
                    time.sleep(0.002)
                t_crash = time.perf_counter()
                crashed_id = leader.id
                cluster.crash(crashed_id)
                crash_s = time.perf_counter() - t_crash
                new = cluster.wait_for_leader(60.0)
                if new is None:
                    raise AssertionError(f"{what}: no new leader")
                elect_s = time.perf_counter() - t_crash
                for j in waves[1][half:]:
                    _on_leader(cluster, lambda ld, j=j: ld.register_job(j),
                               retries, "register_job")
                new = _drain_cluster(cluster, f"{what} wave 2 (new leader)")
                walls.append(time.perf_counter() - t0)
                counts = _ext.COUNTS.snapshot()
                spans = TRACER.spans()
                leader_events = [(t, f) for t, _, _, ev, f
                                 in RECORDER.events("raft")
                                 if ev == "leader" and t >= t_wall]
        finally:
            solver.solve_bulk_multi = real_b1
        stats2 = dict(new.server.plan_applier.stats)

        # the restart from the data directory
        t0 = time.perf_counter()
        back = cluster.restart(crashed_id)
        restart_s = time.perf_counter() - t0
        loaded = back.raft.log.base_index
        feed_back = incremental.feed_for(back.server.store)
        feed_back.sub.next_events()
        sentinel = feed_back.sub.truncated
        deadline = time.time() + 120.0
        while back.raft.last_applied < new.raft.commit_index:
            if time.time() > deadline:
                raise AssertionError(f"{what}: the restarted server did not "
                                     f"catch up ({back.raft.last_applied} "
                                     f"of {new.raft.commit_index})")
            time.sleep(0.01)
        catchup_s = time.perf_counter() - t0
        r0 = feed_back.stats()["resyncs"]
        verified = feed_back.force_verify()
        resynced = feed_back.stats()["resyncs"] - r0
        if not (loaded > 0 and sentinel and verified and resynced == 1):
            raise AssertionError(
                f"{what}: the restart: snapshot base {loaded}, restore "
                f"sentinel seen {sentinel}, feed verified {verified}, "
                f"resyncs {resynced}")
        # every replica the leader's
        deadline = time.time() + 120.0
        while True:
            fps = {sid: replica_fingerprint(sv.local_store)
                   for sid, sv in cluster.servers.items()}
            if len(set(fps.values())) == 1:
                break
            if time.time() > deadline:
                raise AssertionError(
                    f"{what}: replica fingerprints differ: indexes "
                    + str({sid: fp[0] for sid, fp in fps.items()}))
            time.sleep(0.05)

        # gates
        jobs = waves[0] + waves[1]
        statuses = server_gates(new.server, jobs, 2 * n_jobs * k, what)
        snap = new.local_store.snapshot()
        per_job = {j.id: sum(1 for a in snap.allocs_by_job(j.id)
                             if not a.terminal_status()) for j in jobs}
        all_evals = Counter(e.status for e in snap.evals())
        cfg_row = snap.scheduler_configuration()
        snap.close()
        if set(per_job.values()) != {k}:
            raise AssertionError(f"{what}: live allocs a job "
                                 f"{sorted(Counter(per_job.values()).items())}"
                                 f", every job wants exactly {k}")
        if set(all_evals) != {enums.EVAL_STATUS_COMPLETE}:
            raise AssertionError(f"{what}: evals not all complete: "
                                 f"{dict(all_evals)}")
        over = {sid: _over_capacity(sv.local_store)
                for sid, sv in cluster.servers.items()}
        if any(over.values()):
            raise AssertionError(f"{what}: nodes over capacity {over}")
        if (new.server.sched_config.scheduler_algorithm
                != enums.SCHED_ALG_TPU_BINPACK or cfg_row is None
                or cfg_row.scheduler_algorithm
                != enums.SCHED_ALG_TPU_BINPACK):
            raise AssertionError(f"{what}: the new leader's scheduler "
                                 f"config is not tpu-binpack")
        led = {first_id, new.id} | {f.get("node") for _, f in leader_events}
        never_led = [sv for sid, sv in cluster.servers.items()
                     if sid not in led]
        for sv in never_led:
            fs = incremental.feed_for(sv.server.store).stats()
            if fs["twin_uploads"] or fs["builds"]:
                raise AssertionError(f"{what}: follower {sv.id}'s feed "
                                     f"worked: {fs}")

        # the leader's store: dump, restore and the snapshot on disk
        t0 = time.perf_counter()
        dumped = dump_store(new.local_store)
        dump_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_store(StateStore(), dumped)
        restore_s = time.perf_counter() - t0
        snap_bytes = os.path.getsize(
            Path(new.data_dir) / "raft" / "snapshot.json")
        fsync = [r[R_ARGS].get("n", 0) for r in spans
                 if r[R_NAME] == "raft.fsync" and r[R_T0] >= t_wall]
        applied = [r[R_ARGS].get("n", 0) for r in spans
                   if r[R_NAME] == "raft.apply" and r[R_T0] >= t_wall]
        terms1 = {sid: sv.raft.current_term
                  for sid, sv in cluster.servers.items()
                  if sid != crashed_id}
    finally:
        cluster.stop()
        solver.get_service(device).stop()
        shutil.rmtree(data, ignore_errors=True)
        gc.callbacks.remove(watch)

    # replays: every B1 launch under both leaders exact against its plain
    # version and the path's output; B4's
    by_leader = Counter(c[5] for c in b1)
    launched = counts["launches"]
    counted = device == "cpu" or len(b1) == launched["bulk_fill"]
    if not (counted and by_leader[crashed_id] > 0
            and by_leader[new.id] > 0):
        raise AssertionError(f"{what}: B1 launched {launched['bulk_fill']} "
                             f"times, captured {len(b1)}, by leader "
                             f"{dict(by_leader)}")
    for i, (before, args, g, used, cnt, _) in enumerate(b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"{what}: B1 launch {i} differs from its "
                                 f"plain version or the path's output")
    b4_rec = replay_b4(torch, b4, what)
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    placed = n_jobs * k
    rejected = stats1["nodes_rejected"] + stats2["nodes_rejected"]
    e2c = {"p50_ms": 1e3 * REGISTRY.percentile(
        "nomad.eval.enqueue_to_commit", 0.5),
        "p99_ms": 1e3 * REGISTRY.percentile(
        "nomad.eval.enqueue_to_commit", 0.99)}
    spurious = len(leader_events) - 1
    rec = {
        "nodes": n_nodes, "jobs": 2 * n_jobs, "allocs": 2 * placed,
        "waves": [{"allocs": placed, "wall_s": w,
                   "allocs_per_s": placed / w} for w in walls],
        "server_phase": ({"wall_s": server_rec["wall_s"],
                          "allocs_per_s": server_rec["allocs_per_s"],
                          "allocs": server_rec["allocs"]}
                         if server_rec else None),
        "enqueue_to_commit": e2c,
        "commit_rounds": stats1["commit_batches"] + stats2["commit_batches"],
        "batched_commits": (stats1["batched_commits"]
                            + stats2["batched_commits"]),
        "applier": {"first_leader": stats1, "new_leader": stats2},
        "raft_fsync": {"n": len(fsync),
                       "median_batch": (statistics.median(fsync)
                                        if fsync else None)},
        "raft_apply_entries": sum(applied),
        "rejection_rate": rejected / max(2 * placed + rejected, 1),
        "crash": {"committed_jobs_at_crash": done,
                  "registered_before_crash": n_jobs // 2, "crash_s": crash_s,
                  "elect_s": elect_s},
        "restart": {"restart_s": restart_s, "catchup_s": catchup_s,
                    "snapshot_base": loaded, "sentinel": sentinel},
        "snapshots_before_crash": snaps_before,
        "snapshot_bytes": snap_bytes, "dump_s": dump_s,
        "restore_s": restore_s,
        "leader_changes": len(leader_events), "spurious_elections": spurious,
        "client_retries": retries,
        "raft_timers": {"election_timeout_s": REPL_ELECTION_TIMEOUT,
                        "heartbeat_interval_s": REPL_HEARTBEAT},
        "gc": {"collections": len(pauses),
               "full": sum(1 for g, _ in pauses if g == 2),
               "longest_s": max((d for _, d in pauses), default=0.0),
               "total_s": sum(d for _, d in pauses)},
        "terms": {"before": terms0, "after": terms1},
        "evals": statuses, "b1_by_leader": dict(by_leader),
        "b4": b4_rec, "launches": {k: v for k, v in launched.items() if v},
        "card": card}
    base = (f" (the server phase: {server_rec['wall_s']:.3f} s, "
            f"{server_rec['allocs_per_s']:.1f} allocs/s for "
            f"{server_rec['allocs']})" if server_rec else "")
    print(f"{what:<11} [{card}] wave 1 {placed} allocs in {walls[0]:.3f} s"
          f" = {placed / walls[0]:.1f} allocs/s; wave 2 with the crash "
          f"{walls[1]:.3f} s = {placed / walls[1]:.1f} allocs/s{base}")
    print(f"{what:<11} [{card}] enqueue_to_commit p50 {e2c['p50_ms']:.3f} ms"
          f" p99 {e2c['p99_ms']:.3f} ms; commit rounds "
          f"{rec['commit_rounds']} ({rec['batched_commits']} plans); "
          f"raft.fsync {len(fsync)} (median batch "
          f"{rec['raft_fsync']['median_batch']}); raft.apply "
          f"{rec['raft_apply_entries']} entries on 3 replicas; rejection "
          f"rate {rec['rejection_rate']:.6f}")
    print(f"{what:<11} [{card}] crash at {done} of the {n_jobs // 2} jobs "
          f"registered before it committed "
          f"(crash() {crash_s:.3f} s); a new leader serving "
          f"{elect_s:.3f} s after the crash; the restart {restart_s:.3f} s "
          f"(snapshot base {loaded}), caught up {catchup_s:.3f} s after "
          f"it; leader changes {len(leader_events)} (spurious "
          f"{spurious}; the client's retries {retries}; election timeout "
          f"{REPL_ELECTION_TIMEOUT} s); snapshots before the crash "
          f"{snaps_before}; gc {rec['gc']}")
    print(f"{what:<11} [{card}] snapshot {snap_bytes} bytes; dump_store "
          f"{dump_s:.3f} s, restore_store {restore_s:.3f} s of the leader's "
          f"store; B1 launches by leader {dict(by_leader)}, every one "
          f"replayed exact; B4 {b4_rec}; evals {statuses}")
    return launched, rec


# --------------------------------------------------------------------------
# the http phase: the /v1 agent and its client over the Server and the
# raft cluster (ROADMAP A10.1, A28)
# --------------------------------------------------------------------------

HTTP_JOBS = 32          # C2M's batch jobs over POST /v1/jobs
HTTP_SERVICE_K = 64     # a service group B9 places (16 < count < 256)
HTTP_SOLVE_JOBS = 8     # batch jobs placed under "tpu-solve"
HTTP_REPL_NODES = 1024  # the replicated step's depth
HTTP_WAIT = 10.0        # the blocking queries' wait (s)

HTTP_HCL = """
job "%s" {
  datacenters = ["dc1"]
  type = "batch"
  group "web" {
    count = %d
    task "web" {
      driver = "mock"
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""


class _Routes:
    """Per-route client-side latencies and the X-Nomad-Index check: every
    reply's index at most the store's index right after it."""

    def __init__(self, client, store):
        self.client = client
        self.store = store
        self.ms = {}
        self.index_ahead = 0

    def call(self, route, method, path, body=None, params=None):
        t0 = time.perf_counter()
        out, index, headers = self.client.request(method, path, body,
                                                  params)
        self.ms.setdefault(route, []).append(
            1e3 * (time.perf_counter() - t0))
        if index > self.store.latest_index:
            self.index_ahead += 1
        return out, index, headers

    def summary(self) -> dict:
        return {r: {"n": len(v), "p50_ms": float(np.percentile(v, 50)),
                    "p99_ms": float(np.percentile(v, 99))}
                for r, v in self.ms.items()}


def _http_wait_evals(routes, job_ids, stamps, wakes, what, limit=300.0):
    """Blocking queries on /v1/evaluations until each job's newest eval
    is complete (an eval that ran out of plan attempts is failed and its
    blocked successor carries the job on): each parks at the last index
    seen; a reply with a newer index woke on a commit, its latency taken
    from that commit's stamp. Gates that every reply came back within
    its wait."""
    from nomad_tpu_torch.structs import enums

    deadline = time.time() + limit
    index = 0
    while True:
        t0 = time.perf_counter()
        evals, new, _ = routes.call("evals (blocking)", "GET",
                                    "/v1/evaluations",
                                    params={"index": index,
                                            "wait": f"{HTTP_WAIT:g}s"})
        t1 = time.perf_counter()
        if t1 - t0 > HTTP_WAIT + 1.0:
            raise AssertionError(f"{what}: a blocking query took "
                                 f"{t1 - t0:.3f} s, its wait {HTTP_WAIT} s")
        if index and new > index:
            woke = [t for i, t in list(stamps) if i > index]
            if woke:
                wakes.append(1e3 * (t1 - woke[0]))
        index = max(index, new)
        mine = [e for e in evals if e["job_id"] in job_ids]
        newest = {}
        for e in mine:
            if (e["job_id"] not in newest or e["modify_index"]
                    > newest[e["job_id"]]["modify_index"]):
                newest[e["job_id"]] = e
        if (len(newest) == len(job_ids)
                and all(e["status"] == enums.EVAL_STATUS_COMPLETE
                        for e in newest.values())):
            return
        if time.time() > deadline:
            raise AssertionError(
                f"{what}: evals not complete in {limit} s: "
                f"{Counter(e['status'] for e in mine)}; "
                f"{Counter(e['status_description'] for e in mine)}")


def phase_http(torch, card, device="cuda", n_nodes=N_NODES, n_jobs=HTTP_JOBS,
               k=K, workers=SERVER_WORKERS, repl_nodes=HTTP_REPL_NODES):
    """The HTTP API on the card (see the module docstring): returns the
    kernels' launch counts of the single-server run and the phase's
    record."""
    import threading

    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.api import ApiClient, HTTPAgent
    from nomad_tpu_torch.api.codec import from_dict, to_dict
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.obs import TRACER
    from nomad_tpu_torch.obs.export import EVAL_CHAIN
    from nomad_tpu_torch.structs.job import Job
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import kernels, placer, solver
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)
    from nomad_tpu_torch.tensor.scatter import scatter_add_ref

    what = "http"
    t_phase = time.perf_counter()
    srv = Server(ServerConfig(
        num_workers=workers, eval_batch_size=1, device=device,
        nack_timeout=900.0, failed_eval_followup_delay=3600.0,
        failed_eval_unblock_interval=0.5, **BENCH_SAFE))
    svc = solver.get_service(srv.device)
    nodes = _Nodes()
    mock.build_nodes(nodes, n_nodes, seed=0)
    stamps = []   # (index, perf_counter) of every commit
    srv.store.add_commit_listener(
        lambda index, _ev: stamps.append((index, time.perf_counter())))
    b1, b4, b9, b56 = [], [], [], []
    plan_check = {}
    real_b1 = solver.solve_bulk_multi
    real_b9 = placer.solve_task_group_fused
    real_b56 = solver.solve_batch

    def cap_b1(used, *args, g):
        before = used.clone()
        keep = [a.clone() for a in args]
        if plan_check.get("armed"):
            # the first launch after the dry run: the usage it solves
            # against (the carry with its corrections folded) beside the
            # usage built from the store, before this solve commits
            plan_check["armed"] = False
            static = svc._state[0]
            n = len(static.nodes)
            # the plain fold on host copies: a plain version on CUDA
            # would count against the path
            folded = scatter_add_ref(before.to("cpu", copy=True),
                                     args[7].cpu(), args[8].cpu())
            snap = srv.store.snapshot()
            try:
                store_rows = np.zeros((n, before.shape[1]), np.float32)
                for i, nd in enumerate(static.nodes):
                    u = snap.node_usage(nd.id)
                    if u is not None:
                        store_rows[i] = u
            finally:
                snap.close()
            plan_check["folded"] = folded[:n].numpy()
            plan_check["store"] = store_rows
            plan_check["corrections"] = int((args[7] != 0).sum())
            plan_check["resyncs"] = svc.stats["resyncs"]
        out = real_b1(used, *args, g=g)
        b1.append((before, keep, g, out[0].clone(), out[1].clone()))
        return out

    def cap_b9(*packed):
        snap = [t.clone() for t in packed]
        out = real_b9(*packed)
        b9.append((snap, out.clone()))
        return out

    def cap_b56(*args, **kw):
        b56.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                    dict(kw)))
        return real_b56(*args, **kw)

    agent = None
    stream = {}
    wakes = []
    try:
        srv.start()
        t0 = time.perf_counter()
        srv.register_nodes(nodes)
        nodes_s = time.perf_counter() - t0
        agent = HTTPAgent(srv, port=0).start()
        client = ApiClient(agent.address, timeout=120.0)
        routes = _Routes(client, srv.store)
        # 2. the scheduler configuration
        cfg0, _, _ = routes.call("operator", "GET",
                                 "/v1/operator/scheduler/configuration")
        routes.call("operator", "PUT", "/v1/operator/scheduler/configuration",
                    {**cfg0, "scheduler_algorithm":
                     enums.SCHED_ALG_TPU_BINPACK})
        if srv.sched_config.scheduler_algorithm != enums.SCHED_ALG_TPU_BINPACK:
            raise AssertionError(f"{what}: the operator endpoint did not set "
                                 f"tpu-binpack")
        # a warm job, so the timed jobs find the kernels warm; it stays:
        # the service's carry counts freed capacity until its next
        # resync, and the dry run's check below compares it with the
        # store exactly
        warm = mock.service_job(k, cpu=50, mem=32, batch=True)
        routes.call("warm", "POST", "/v1/jobs", {"job": to_dict(warm)})
        _drain(srv, f"{what} warm-up")
        print(f"{what:<11} setup {time.perf_counter() - t_phase:.2f} s "
              f"({n_nodes} nodes through register_nodes in {nodes_s:.2f} s, "
              f"agent at {agent.address}, {workers} workers)")

        jobs = [mock.service_job(k, cpu=50, mem=32, batch=True)
                for _ in range(n_jobs - 1)]
        parsed_id = f"http-parsed-{os.getpid()}"
        TRACER.clear()
        solver.solve_bulk_multi = cap_b1
        placer.solve_task_group_fused = cap_b9
        solver.solve_batch = cap_b56
        with capture_b4(b4):
            _ext.COUNTS.reset()
            t_wall = time.perf_counter()
            t_epoch = time.time()

            def events():
                stream["events"] = list(client.stream_events(
                    ["Job"], wait_s=5.0))
            reader = threading.Thread(target=events)
            waiters0 = srv.events.waiter_count()
            reader.start()
            deadline = time.time() + 10.0
            while srv.events.waiter_count() <= waiters0:
                if time.time() > deadline:
                    raise AssertionError(f"{what}: the event stream did "
                                         f"not subscribe")
                time.sleep(0.005)
            # 3. the batch jobs: one parsed from HCL-like text
            spec, _, _ = routes.call("parse", "POST", "/v1/jobs/parse",
                                     {"job_hcl": HTTP_HCL % (parsed_id, k)})
            parsed = from_dict(Job, spec)
            t0 = time.perf_counter()
            for body in [spec] + [to_dict(j) for j in jobs]:
                routes.call("register", "POST", "/v1/jobs", {"job": body})
            job_ids = {parsed_id} | {j.id for j in jobs}
            _http_wait_evals(routes, job_ids, stamps, wakes, what)
            _drain(srv, f"{what} batch jobs")
            batch_s = time.perf_counter() - t0
            reader.join(30.0)
            via_api = 0
            for jid in sorted(job_ids):
                allocs, _, _ = routes.call("allocations", "GET",
                                           f"/v1/job/{jid}/allocations")
                via_api += sum(1 for a in allocs
                               if a["client_status"] not in _CLIENT_DONE
                               and a["desired_status"] == "run")
            by_store = _committed_jobs(srv.store, [parsed] + jobs, k)
            if via_api != n_jobs * k or by_store != n_jobs:
                raise AssertionError(f"{what}: {via_api} live allocs by the "
                                     f"API, {by_store} jobs complete in the "
                                     f"store, want {n_jobs * k}")
            over = _over_capacity(srv.store)
            if over:
                raise AssertionError(f"{what}: {over} nodes over capacity")
            seen = {e["Key"] for e in stream.get("events", [])
                    if e["Topic"] == "Job"}
            if not job_ids <= seen:
                raise AssertionError(f"{what}: the event stream missed "
                                     f"{len(job_ids - seen)} registrations")

            # 4. the dry run, then the job registered
            planned = mock.service_job(k, cpu=50, mem=32, batch=True)
            index0 = srv.store.latest_index
            launches0 = len(b1)
            plan, _, _ = routes.call("plan", "POST",
                                     f"/v1/job/{planned.id}/plan",
                                     {"job": to_dict(planned)})
            place = plan["annotations"]["web"]["place"]
            if srv.store.latest_index != index0 or place != k:
                raise AssertionError(f"{what}: the dry run moved the index "
                                     f"{index0} -> {srv.store.latest_index} "
                                     f"or placed {place}, want {k}")
            if len(b1) != launches0 + 1:
                raise AssertionError(f"{what}: the dry run launched B1 "
                                     f"{len(b1) - launches0} times")
            plan_check["armed"] = True
            routes.call("register", "POST", "/v1/jobs",
                        {"job": to_dict(planned)})
            _drain(srv, f"{what} planned job")
            if "folded" not in plan_check:
                raise AssertionError(f"{what}: no launch after the dry run")
            if not np.array_equal(plan_check["folded"], plan_check["store"]):
                diff = np.abs(plan_check["folded"]
                              - plan_check["store"]).max()
                raise AssertionError(f"{what}: the launch after the dry run "
                                     f"solves against usage {diff} off the "
                                     f"store's")
            if _committed_jobs(srv.store, [planned], k) != 1:
                raise AssertionError(f"{what}: the planned job did not place")

            # 5. a service group through B9, then tpu-solve
            svc_job = mock.service_job(HTTP_SERVICE_K, cpu=50, mem=32)
            routes.call("register", "POST", "/v1/jobs",
                        {"job": to_dict(svc_job)})
            _drain(srv, f"{what} service job")
            routes.call("operator", "PUT",
                        "/v1/operator/scheduler/configuration",
                        {**cfg0, "scheduler_algorithm":
                         enums.SCHED_ALG_TPU_SOLVE})
            solve_jobs = [mock.service_job(k, cpu=50, mem=32, batch=True)
                          for _ in range(HTTP_SOLVE_JOBS)]
            for j in solve_jobs:
                routes.call("register", "POST", "/v1/jobs",
                            {"job": to_dict(j)})
            _http_wait_evals(routes, {j.id for j in solve_jobs}, stamps,
                             wakes, f"{what} tpu-solve")
            _drain(srv, f"{what} tpu-solve jobs")
            wall = time.perf_counter() - t_wall
            counts = _ext.COUNTS.snapshot()
        solver.solve_bulk_multi = real_b1
        placer.solve_task_group_fused = real_b9
        solver.solve_batch = real_b56
        everything = [warm, parsed] + jobs + [planned, svc_job] \
            + solve_jobs
        want = (n_jobs + 2 + HTTP_SOLVE_JOBS) * k + HTTP_SERVICE_K
        statuses = server_gates(srv, everything, want, what)

        # 6. reads
        text = client.metrics_prometheus()
        samples = [ln for ln in text.splitlines()
                   if ln and not ln.startswith("#")]
        for ln in samples:
            name, value = ln.split(" ")
            float(value)
        traces, _, _ = routes.call("traces", "GET", "/v1/traces",
                                   params={"limit": 0})
        names = {}
        for ev in traces["trace"]["traceEvents"]:
            args = ev["args"]
            for tid in [args.get("trace")] + list(args.get("traces") or ()):
                if tid:
                    names.setdefault(tid, set()).add(ev["name"])
        snap = srv.store.snapshot()
        try:
            # the warm job's spans went with the clear before the run
            committed = [e for j in everything[1:]
                         for e in snap.evals_by_job(j.id)
                         if e.status == enums.EVAL_STATUS_COMPLETE]
            loaded = max(snap.nodes(), key=lambda nd: len(
                snap.allocs_by_node(nd.id)))
            on_node = len(snap.allocs_by_node(loaded.id))
        finally:
            snap.close()
        broken = [e.id for e in committed
                  if not set(EVAL_CHAIN) <= names.get(e.trace(), set())]
        if broken:
            raise AssertionError(f"{what}: {len(broken)} of "
                                 f"{len(committed)} committed evals lack a "
                                 f"complete span chain in /v1/traces")
        node_allocs, _, _ = routes.call("node allocations", "GET",
                                        f"/v1/node/{loaded.id}/allocations")
        if len(node_allocs) != on_node:
            raise AssertionError(f"{what}: /v1/node/<id>/allocations gave "
                                 f"{len(node_allocs)}, the store {on_node}")
        if routes.index_ahead:
            raise AssertionError(f"{what}: {routes.index_ahead} replies "
                                 f"carried an X-Nomad-Index ahead of the "
                                 f"store")
        route_ms = routes.summary()
        applier = dict(srv.plan_applier.stats)
        spans = span_split(TRACER.spans(), t_epoch)
    finally:
        solver.solve_bulk_multi = real_b1
        placer.solve_task_group_fused = real_b9
        solver.solve_batch = real_b56
        if agent is not None:
            agent.stop()
        srv.stop()
        svc.stop()

    # replays: every captured launch against its plain version
    launched = counts["launches"]
    need = ("bulk_fill", "scatter_add", "solve_task_group", "auction",
            "batch_pick")
    if device != "cpu":
        missing = [n for n in need if not launched.get(n)]
        if missing:
            raise AssertionError(f"{what}: {missing} never launched: "
                                 f"{launched}")
        if (len(b1) != launched["bulk_fill"] - launched["auction"]
                or len(b56) != launched["auction"]
                or len(b9) != launched["solve_task_group"]):
            raise AssertionError(f"{what}: captured B1 {len(b1)}, joint "
                                 f"{len(b56)}, B9 {len(b9)} of {launched}")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    for i, (before, args, g, used, cnt) in enumerate(b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"{what}: B1 launch {i} differs from its "
                                 f"plain version or the path's output")
    err = 0.0
    for i, (packed, out) in enumerate(b9):
        got = kernels.solve_task_group_fused(*packed)
        want9 = kernels.solve_task_group_fused_ref(*packed)
        if not (torch.equal(got[:2], want9[:2]) and torch.equal(got, out)):
            raise AssertionError(f"{what}: B9 launch {i} differs from its "
                                 f"plain version or the path's output")
        err = max(err, score_err(got[2], want9[2], f"{what} B9 {i}"))
    for i, (args, kw) in enumerate(b56):
        used0, rest = args[0], args[1:]
        s_got = bs.solve_batch(used0.clone(), *rest, **kw)
        s_want = bs.solve_batch_ref(used0.clone(), *rest, **kw)
        for name, x, y in zip(("used", "counts", "info"), s_got, s_want):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: joint launch {i}: "
                                     f"solve_batch {name} differs from the "
                                     f"plain version")
    b4_rec = replay_b4(torch, b4, what)

    repl = http_replicated(torch, card, device, repl_nodes, k)
    wall_phase = time.perf_counter() - t_phase
    wake = ({"n": len(wakes), "p50_ms": float(np.percentile(wakes, 50)),
             "p99_ms": float(np.percentile(wakes, 99))} if wakes else None)
    rec = {"nodes": n_nodes, "jobs": n_jobs + 1 + HTTP_SOLVE_JOBS,
           "allocs": want, "batch_jobs_s": batch_s, "wall_s": wall,
           "phase_wall_s": wall_phase, "routes": route_ms,
           "blocking_wake": wake, "evals": statuses,
           "spans": spans, "nodes_rejected": applier["nodes_rejected"],
           "partial_commits": applier["partial_commits"],
           "plan_launch": {"corrections": plan_check["corrections"],
                           "resyncs": plan_check["resyncs"]},
           "prometheus_samples": len(samples),
           "trace_events": len(traces["trace"]["traceEvents"]),
           "committed_evals_traced": len(committed),
           "replays": {"bulk_fill": len(b1), "solve_task_group": len(b9),
                       "solve_batch": len(b56), "b9_max_score_err": err,
                       "scatter_add": b4_rec},
           "launches": {n: v for n, v in launched.items() if v},
           "replicated": repl, "card": card}
    print(f"{what:<11} [{card}] {n_jobs} batch jobs x {k} over HTTP in "
          f"{batch_s:.3f} s; the timed run {wall:.3f} s, the phase "
          f"{wall_phase:.3f} s; per route "
          + "; ".join(f"{r} p50 {v['p50_ms']:.3f} ms p99 "
                      f"{v['p99_ms']:.3f} ms ({v['n']})"
                      for r, v in route_ms.items()))
    print(f"{what:<11} [{card}] evals {statuses}; the applier rejected "
          f"{applier['nodes_rejected']} nodes ({applier['partial_commits']} "
          f"partial commits); span p50 ms "
          + "; ".join(f"{n} {v['p50_ms']:.3f} ({v['n']})"
                      for n, v in spans.items()))
    print(f"{what:<11} [{card}] blocking-query wake (commit to reply) "
          f"{wake}; the dry run's next launch folded "
          f"{plan_check['corrections']} corrections and equals the store; "
          f"launches {rec['launches']}; replays exact: B1 {len(b1)}, B9 "
          f"{len(b9)} (scores within {SCORE_TOL}, max {err:.3g}), "
          f"solve_batch (B5, the pick and B4's fold inside it) "
          f"{len(b56)}, B4 outside solve_batch {b4_rec}")
    print(f"{what:<11} [{card}] replicated: {repl}")
    return launched, rec


_CLIENT_DONE = ("complete", "failed", "lost")


def http_replicated(torch, card, device, n_nodes, k):
    """Three servers at ``n_nodes``, an agent on each with its
    ReplicatedServer as writer: a job registered through a follower's
    agent, read there with the follower-read headers; the leader crashed;
    the follower names the new leader and a second job through it
    places."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.api import ApiClient, HTTPAgent
    from nomad_tpu_torch.api.codec import to_dict
    from nomad_tpu_torch.core.server import ServerConfig
    from nomad_tpu_torch.raft import RaftCluster
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import solver

    what = "http repl"
    tpu = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)

    def cfg(i):
        return ServerConfig(
            num_workers=4, eval_batch_size=1, device=device,
            sched_config=tpu, nack_timeout=900.0,
            failed_eval_followup_delay=3600.0,
            failed_eval_unblock_interval=0.5, **BENCH_SAFE)

    t0 = time.perf_counter()
    cluster = RaftCluster(3, config_fn=cfg,
                          election_timeout=REPL_ELECTION_TIMEOUT,
                          heartbeat_interval=REPL_HEARTBEAT)
    agents = {}
    retries = {}
    try:
        cluster.start()
        leader = cluster.wait_for_leader(30.0)
        if leader is None:
            raise AssertionError(f"{what}: no leader elected")
        nodes = _Nodes()
        mock.build_nodes(nodes, n_nodes, seed=0)
        _on_leader(cluster, lambda ld: ld.register_nodes(list(nodes)),
                   retries, "register_nodes")
        for sid, sv in cluster.servers.items():
            agents[sid] = HTTPAgent(sv.server, port=0, writer=sv).start()
        leader = cluster.wait_for_leader(30.0)
        follower = next(sv for sv in cluster.servers.values()
                        if sv is not leader)
        api = ApiClient(agents[follower.id].address, timeout=120.0)
        first = mock.service_job(k, cpu=50, mem=32, batch=True)
        api.register_job(to_dict(first))
        leader = _drain_cluster(cluster, f"{what} first job")
        _, index, headers = api.request("GET", f"/v1/job/{first.id}/"
                                        "allocations")
        live = sum(1 for a in api.job_allocations(first.id)
                   if a["desired_status"] == "run")
        known = headers.get("X-Nomad-KnownLeader")
        contact = headers.get("X-Nomad-LastContact")
        if (live != k or known != "true" or contact is None
                or index > follower.local_store.latest_index):
            raise AssertionError(f"{what}: the follower read {live} allocs, "
                                 f"KnownLeader {known}, LastContact "
                                 f"{contact}, index {index}")
        agents.pop(leader.id).stop()
        t_crash = time.perf_counter()
        cluster.crash(leader.id)
        new = cluster.wait_for_leader(60.0)
        if new is None:
            raise AssertionError(f"{what}: no new leader")
        elect_s = time.perf_counter() - t_crash
        deadline = time.time() + 30.0
        while api.leader().get("leader") != new.id:
            if time.time() > deadline:
                raise AssertionError(f"{what}: the follower does not name "
                                     f"the new leader")
            time.sleep(0.02)
        second = mock.service_job(k, cpu=50, mem=32, batch=True)
        api.register_job(to_dict(second))
        new = _drain_cluster(cluster, f"{what} second job")
        placed = _committed_jobs(new.local_store, [first, second], k)
        if placed != 2 or _over_capacity(new.local_store):
            raise AssertionError(f"{what}: {placed} of 2 jobs placed after "
                                 f"the crash")
        return {"nodes": n_nodes, "allocs": 2 * k, "elect_s": elect_s,
                "last_contact_ms": int(contact),
                "wall_s": time.perf_counter() - t0,
                "client_retries": retries}
    finally:
        for a in agents.values():
            a.stop()
        cluster.stop()
        solver.get_service(device).stop()


def http_only(torch, card) -> int:
    """``--http``: the build and the http phase alone; its record and the
    kernels' launches on it as JSON lines."""
    launched, rec = phase_http(torch, card)
    print(json.dumps({"http": rec}))
    print(json.dumps({"kernels": [
        {"name": n, "http_launches": launched[n]}
        for n in ("bulk_fill", "scatter_add", "solve_task_group", "auction",
                  "batch_pick")]}))
    print(card)
    return 0


def replicated_only(torch, card) -> int:
    """``--replicated``: the build and the replicated phase alone; its
    record and B1's and B4's launches on it as JSON lines."""
    launched, rec = phase_replicated(torch, card)
    print(json.dumps({"replicated": rec}))
    print(json.dumps({"kernels": [
        {"name": "bulk_fill", "replicated_launches": launched["bulk_fill"]},
        {"name": "scatter_add",
         "replicated_launches": launched["scatter_add"]}]}))
    print(card)
    return 0


def autopilot_only(torch, card) -> int:
    """``--autopilot``: the build and the autopilot phase alone; its
    record as a JSON line."""
    launched, rec = phase_autopilot(torch, card)
    print(json.dumps({"autopilot": rec}))
    print(card)
    return 0


def lifecycle_only(torch, card) -> int:
    """``--lifecycle``: the build and the lifecycle phase alone; its
    record and its B9 kernel record as JSON lines."""
    _, rec, kernel = phase_lifecycle(torch, card)
    print(json.dumps({"lifecycle": rec}))
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    return 0


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
    the narrow instance's widest) with three spreads and a
    distinct_property (the full cache)."""
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
        failed_eval_unblock_interval=0.5, **BENCH_SAFE))
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


def wide_capacity(n_pad: int) -> tuple:
    """(real nodes, (real, 4) capacities) at N_pad ``n_pad``: C2M's
    10,240 build_nodes capacities at 16,384, else 5/8 of the rows (C2M's
    ratio) with those capacities tiled."""
    if n_pad == N_PAD:
        return N_NODES, c2m_capacity()
    real = n_pad * 5 // 8
    return real, np.resize(c2m_capacity(), (real, 4))


def b11_inputs(rng, variant: str, n_pad: int = N_PAD):
    """One bulk scan at the C2M width (10,240 build_nodes capacities
    padded to 16,384, D 4, usage at 0-99 allocs of (50, 32, 300) a node;
    at another ``n_pad``, wide_capacity's rows)
    as (form, args, kwargs): "main" fused with k 40,000; "over" fused with
    an ask that leaves a remainder; "zero_ask" fused with an all-zero ask
    (infinite caps clamped to the budget); "spread_alg", "dh_tg" and
    "spreads" (two tables: explicit targets, and even spread over 32
    values) through the generic form with its own permutation;
    "identical" fused on identical empty nodes, where the permutation
    decides every step."""
    f = np.float32
    n_nodes, cap = wide_capacity(n_pad)
    avail = np.zeros((n_pad, 4), f)
    avail[:n_nodes] = cap
    used = np.zeros((n_pad, 4), f)
    fill = rng.integers(0, 100, n_nodes).astype(f)
    used[:n_nodes, :3] = fill[:, None] * np.array([50, 32, 300], f)
    feas = np.zeros(n_pad, bool)
    feas[:n_nodes] = rng.random(n_nodes) < 0.95
    aff = np.zeros(n_pad, f)
    aff[:n_nodes] = rng.choice([0.0, 0.0, 0.0, 0.5, -0.5], n_nodes)
    ptg = np.zeros(n_pad, np.int32)
    ptg[:n_nodes] = rng.integers(0, 3, n_nodes)
    ask = np.array([50, 32, 300, 0], f)
    k = LARGE_K
    if variant == "identical":
        avail[:n_nodes] = avail[0]
        used[:] = 0.0
        aff[:] = 0.0
        ptg[:] = 0
        feas[:n_nodes] = True
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
    svid = rng.integers(0, v, (s, n_pad)).astype(np.int32)
    sok = rng.random((s, n_pad)) < 0.9
    scnt = rng.integers(0, 50, (s, v)).astype(np.int32)
    desired = np.full((s, v), np.nan, f)
    if s:
        desired[0] = rng.integers(0, 400, v)
        desired[0, 3] = 0.0
    has_targets = np.arange(s) == 0
    weight = np.full(s, 0.5, f)
    perm = rng.permutation(n_pad).astype(np.int32)
    args = [avail, used, ask, feas, ptg, ptg.copy(), aff, np.zeros(n_pad, f),
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
# buffers are in a global scratch (the big_cluster path's N_pad 32,768)
PERM_SIZES = (1024, N_PAD, 32768, 65536)
PERM_TIMED = (N_PAD, 32768, 65536)
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
          f"{'; '.join(timed)}; refused before running: {refused}")


def b11_refusals(torch, dev):
    """The shapes the scan refuses: a batch above the 16-bit cap field
    (the kernel's entry, which the wrapper leaves to it: a launch error)
    and spread count tables that do not fit in shared memory (the cached
    terms move to the scratch first; the wrapper raises ValueError). Each
    must raise before anything runs."""
    from nomad_tpu_torch.tensor import kernels

    f32, i32, b8 = torch.float32, torch.int32, torch.bool

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cases = {"batch 65,536": (4, 0, 1, 65536, RuntimeError,
                              "bulk_scan launch"),
             "8 spreads of 4,096 values": (4, 8, 4096, 256, ValueError,
                                           "bytes of shared memory")}
    for name, (d, s, v, batch, error, says) in cases.items():
        args = (z(N_PAD, d), z(N_PAD, d), z(d), z(N_PAD, dtype=b8),
                z(N_PAD, dtype=i32), z(N_PAD, dtype=i32), z(N_PAD), z(N_PAD),
                z(s, N_PAD, dtype=i32), z(s, N_PAD, dtype=b8),
                z(s, v, dtype=i32), z(s, v), z(s, dtype=b8), z(s), 10, 10.0,
                False, False, False,
                torch.arange(N_PAD, dtype=i32, device=dev))
        try:
            kernels.solve_bulk(*args, batch=batch, n_steps=1)
        except error as e:
            if says in str(e):
                continue
            raise
        raise AssertionError(f"B11: the scan took {name}")
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
        rec["joint"].append((ms, plain, joint_bound(
            torch, mesh, full, args[4:], kw, int(got[3])), one_ms,
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


def joint_bound(torch, mesh, full, rep, kw, gathers):
    """Least time of one B14 launch on these inputs (``full`` the gathered
    used, avail, feas and aff; ``rep`` the replicated ask, k, seeds, cidx
    and cdelta): the whole launch's work, each input read and each output
    written once: the greedy arm's (B13's work, its pools among it), the
    restarts' rounds and gathered pools, their fold_in draws, the arm
    scores and the pick, the info row and the gather count."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.prng import jitter_fold
    from nomad_tpu_torch.tensor.scatter import scatter_add_ref

    his, eps = bs._jitter_his(), bs._price_eps()
    ask, k, seeds, cidx, cdelta = rep
    n, g = full[0].shape[0], ask.shape[0]
    folded = scatter_add_ref(full[0].clone(), cidx, cdelta).clamp_min(0.0)
    ev_kw = {key: sh.gather_rows(kw[key]) for key in ("evict", "net_prio")
             if kw.get(key) is not None}
    a_ops, run, _ = auction_ops(torch, folded, full[1], full[2], full[3],
                                ask, k, jitter_fold(seeds, n, his), eps,
                                kw.get("rounds", 64), **ev_kw)
    greedy_rounds = gathers - sum(run) - len(run) - 1
    n_bytes, ops = b13_work(n, g, cidx.shape[0], mesh.size, greedy_rounds,
                            min(kw.get("top_r", 64), n // mesh.size))
    n_bytes += (pool_bytes(mesh.size, sum(run), g * min(16, n // mesh.size))
                + 28 + (n * 20 if ev_kw else 0))
    ops += (a_ops + len(his) * g * (n + 1) * 120
            + (len(eps) + 1) * n * (g + 60))
    return bound(n_bytes, ops)


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


# the kernel-alone widths above the one-CTA kernels' old ceilings: a
# 20,000-node cluster's N_pad, and the one-card ceiling (ROADMAP A11d)
WIDE_PADS = (32768, 65536)


def stride_inputs(torch, dev, rng, n_pad: int):
    """solve_inputs' "main" at ``n_pad`` with every node full but those of
    two B5 scan threads (node i mod 1,024 in {5, 600}: each thread scores
    n_pad / 1,024 nodes of a row, all of which fit, so it turns keys away
    that beat the rest of its lane and set the lane's floor) and one in a
    thousand others; the demand takes rounds and rescans of them."""
    t = solve_inputs(torch, dev, rng, "main", n_pad=n_pad)
    n_nodes, _ = wide_capacity(n_pad)
    node = np.arange(n_pad)
    open_nodes = ((np.isin(node % 1024, (5, 600)) | (rng.random(n_pad)
                                                      < 0.001))
                  & (node < n_nodes))
    avail = t["avail"].cpu().numpy()
    used = avail.copy()
    used[:, 3] = 0.0
    used[open_nodes, :3] = np.floor(avail[open_nodes, :3] * 0.6)
    t["used"] = torch.tensor(used, device=dev)
    t["k"] = torch.full_like(t["k"], 300)
    t["tgc"] = t["k"].float()
    return t


def phase_wide_kernels(torch, dev, card, rng):
    """B11, B5 (with the pick and solve_batch), B13 and B14 above 16,384
    nodes, each exact against its plain version at WIDE_PADS (``--wide``
    runs this phase alone): B11 on "main" (fused, k 40,000), "spreads"
    and "spread_alg" (generic), its keys and caps in the global scratch,
    each step's level by threshold_radix; B5 on "main" and "stride", a
    scan thread over 32 or 64 nodes of a row; B13 at S = 1 (n_loc up to
    65,536) and S = 2 on B1's hazards and at top_r 8 on one alloc a node,
    each round's pool selected from the scratch, against single-device B1
    too; B14 at S = 1 and S = 2 (the pick over 65,536 nodes in chunks),
    against single-device solve_batch too. Each timed beside its plain
    version on "main". Returns {kernel name: {n_pad: record}}."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import bulk_fill
    from nomad_tpu_torch.tensor.prng import jitter_fold_ref

    eps, his = bs._price_eps(), bs._jitter_his()
    out = {"bulk_scan": {}, "auction": {}, "bulk_shard": {},
           "joint_shard": {}}
    notes = []
    for n_pad in WIDE_PADS:
        # B11
        for variant in ("main", "spreads", "spread_alg"):
            form, host, scalars = b11_inputs(rng, variant, n_pad)
            got = b11_call(torch, dev, form, host, scalars)
            want = b11_call(torch, dev, form, host, scalars, plain=True)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"B11 {variant} at N_pad {n_pad}: counts differ from "
                    f"the plain version on {int((got != want).sum())} nodes")
            placed = int(got.sum())
            if variant != "spread_alg" and placed != scalars[0]:
                raise AssertionError(f"B11 {variant} at N_pad {n_pad}: "
                                     f"placed {placed} of {scalars[0]}")
            notes.append(f"B11 {variant} N_pad {n_pad}: {placed} on "
                         f"{int((got > 0).sum())} nodes")
            if variant == "main":
                run = b11_runner(torch, dev, form, host, scalars)
                plain = b11_runner(torch, dev, form, host, scalars, True)
                ms = cuda_time_ms(torch, lambda _: run(), reps=5)
                steps = -(-placed // 256)
                b_ms, b_by = b11_bound(n_pad, 4, int(host[1].sum()),
                                       got.cpu().numpy())
                out["bulk_scan"][str(n_pad)] = {
                    "ms": ms, "ms_per_step": ms / steps,
                    "plain_ms": cuda_time_ms(torch, lambda _: plain(),
                                             reps=2, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by}
        # B5, the pick and solve_batch
        for variant in ("main", "stride"):
            t = (solve_inputs(torch, dev, rng, "main", n_pad=n_pad)
                 if variant == "main" else stride_inputs(torch, dev, rng,
                                                         n_pad))
            jits = jitter_fold_ref(t["seeds"], n_pad, his)
            a_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"])
            scans = torch.zeros(len(eps), dtype=torch.int32, device=dev)
            got = bs.auction(t["used"], *a_args, t["seeds"], his=his,
                             price_eps=eps, scans=scans)
            check_auction(torch, bs, got, t["used"], a_args, jits, eps,
                          f"{variant} at N_pad {n_pad}")
            used_g = torch.clamp_min(t["used"], 0.0)
            counts_g = bulk_fill(used_g, *a_args, t["seeds"])
            p_args = (t["avail"], *got, used_g, counts_g)
            check_pick(torch, bs, bs.batch_pick(*p_args), p_args,
                       f"{variant} at N_pad {n_pad}")
            s_args = (t["avail"], t["feas"], t["aff"], t["ask"], t["k"],
                      t["tgc"], t["seeds"], t["cidx"], t["cdelta"])
            s_got = bs.solve_batch(t["used"].clone(), *s_args, g=G)
            s_want = bs.solve_batch_ref(t["used"].clone(), *s_args, g=G)
            torch.cuda.synchronize()
            for name, x, y in zip(("used", "counts", "info"), s_got,
                                  s_want):
                if not torch.equal(x, y):
                    raise AssertionError(f"B6 solve_batch {variant} at N_pad "
                                         f"{n_pad}: {name} differs")
            notes.append(f"B5 {variant} N_pad {n_pad}: rounds "
                         f"{got[2].tolist()}, scans {scans.tolist()}, "
                         f"placed {int(got[1][0].sum())}")
            if variant == "main":
                ms = cuda_time_ms(torch, lambda _: bs.auction(
                    t["used"], *a_args, t["seeds"], his=his, price_eps=eps),
                    reps=5)
                plain = cuda_time_ms(torch, lambda _: bs.auction_restarts_ref(
                    t["used"], *a_args, jits, price_eps=eps), reps=1,
                    warmup=1)
                (b_ms, b_by), rounds, _ = auction_bound(
                    torch, t["used"], *a_args, jits, eps)
                out["auction"][str(n_pad)] = {
                    "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "rounds": rounds}
                joint_t = t
        # B13 at S = 1 and 2; the first checked timed at S = 1
        t1 = wide_fill_inputs(torch, dev, rng, n_pad)
        tight = cfg7_inputs(torch, dev, tight=True)
        tight = padded(torch, tight, n_pad)
        for s_n in (1, 2):
            mesh = mesh_of(s_n)
            rounds = check_b13(torch, mesh, t1, 64, f"N_pad {n_pad} S={s_n}")
            rt = check_b13(torch, mesh, tight, 8,
                           f"top_r 8 N_pad {n_pad} S={s_n}")
            notes.append(f"B13 N_pad {n_pad} S {s_n}: rounds {sum(rounds)}, "
                         f"top_r 8 {max(rt)} the most an eval")
            if s_n == 1:
                rep = (t1["ask"], t1["k"], t1["seeds"], t1["cidx"],
                       t1["cdelta"])
                ms = cuda_time_ms(
                    torch, lambda a: sh.solve_bulk_multi_sharded(
                        mesh, *a, *rep, g=G),
                    setup=lambda: shard_args(mesh, t1)[0], reps=5)
                plain = cuda_time_ms(
                    torch, lambda a: sh.solve_bulk_multi_sharded_ref(
                        mesh, *a, *rep, g=G),
                    setup=lambda: shard_args(mesh, t1)[0], reps=2, warmup=1)
                b_ms, b_by = bound(*b13_work(n_pad, G, 64, 1, sum(rounds),
                                             64))
                out["bulk_shard"][str(n_pad)] = {
                    "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "rounds": sum(rounds), "shards": 1}
        # B14 on B5's "main" inputs at S = 1 (n_loc up to 65,536) and 2
        t = joint_t
        rep = (t["ask"], t["k"], t["seeds"], t["cidx"], t["cdelta"])
        one = bs.solve_batch(t["used"].clone(), t["avail"], t["feas"],
                             t["aff"], t["ask"], t["k"], t["tgc"], t["seeds"],
                             t["cidx"], t["cdelta"], g=G)
        for s_n in (1, 2):
            mesh = mesh_of(s_n)
            args, _ = shard_args(mesh, t)
            got = one_launch_a_card(
                mesh, "joint_shard", f"B14 N_pad {n_pad} S={s_n}",
                lambda: sh.solve_batch_sharded(mesh, *args, *rep, g=G))
            args, _ = shard_args(mesh, t)
            want = sh.solve_batch_sharded_ref(mesh, *args, *rep, g=G)
            torch.cuda.synchronize()
            gu, gc = sh.gather_rows(got[0]), sh.gather_rows(got[1], dim=1)
            for name, x, y in (
                    ("used", gu, sh.gather_rows(want[0])),
                    ("counts", gc, sh.gather_rows(want[1], dim=1)),
                    ("info", got[2], want[2]), ("gathers", got[3], want[3])):
                if not torch.equal(x, y):
                    raise AssertionError(f"B14 N_pad {n_pad} S={s_n}: {name} "
                                         f"differs from the plain version")
            if not (torch.equal(gc, one[1]) and torch.equal(gu, one[0])
                    and torch.equal(got[2][2:], one[2][2:])):
                raise AssertionError(f"B14 N_pad {n_pad} S={s_n}: differs "
                                     f"from single-device solve_batch")
            notes.append(f"B14 N_pad {n_pad} S {s_n}: gathers "
                         f"{int(got[3])}")
            if s_n == 2:
                ms = cuda_time_ms(torch, lambda a: sh.solve_batch_sharded(
                    mesh, *a, *rep, g=G),
                    setup=lambda: shard_args(mesh, t)[0], reps=3)
                plain = cuda_time_ms(
                    torch, lambda a: sh.solve_batch_sharded_ref(
                        mesh, *a, *rep, g=G),
                    setup=lambda: shard_args(mesh, t)[0], reps=1, warmup=1)
                full = [t["used"], t["avail"], t["feas"], t["aff"]]
                b_ms, b_by = joint_bound(torch, mesh, full, rep, {},
                                         int(got[3]))
                out["joint_shard"][str(n_pad)] = {
                    "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "shards": 2}
    print(f"wide        [{card}] exact against the plain versions at N_pad "
          f"{WIDE_PADS}: " + "; ".join(notes))
    for name, by_n in out.items():
        print(f"wide        [{card}] {name}: " + "; ".join(
            f"N_pad {n}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})"
            for n, r in by_n.items()))
    return out


# the big_cluster phase: a 20,000-node cluster (N_pad 32,768) through the
# port's Server on every device path of the wide kernels (ROADMAP A11b)
BIG_NODES = 20000
BIG_JOBS = 16            # steps 1 and 5: batch jobs x K
BIG_LARGE_JOBS = 2       # step 2: groups of LARGE_K (B11' then B11)
# step 3: the reader group. Each CSI claim a plan commits copies the
# volume's claim map (the reference's store does the same), so a group's
# claims cost O(k^2) on the host: 40,000 readers took 156 s to commit on
# the CPU (the plan apply timed out at the default nack timeout)
BIG_READER_K = 4000
BIG_SVC_K = 512          # step 4: a service group with a spread (B9)
BIG_SHARDS = (1, 2)      # step 6: the node-sharded service on one card
BIG_MESH_JOBS = 8        # step 6: jobs a mesh path
BIG_PARITY_SOLVE = 2     # the tpu-solve wave held card == CPU


def big_jobs(mock, n, k, tag, asks=((50, 32),)):
    """n batch jobs of k allocs, the asks in turn, ids pinned by tag."""
    jobs = []
    for i in range(n):
        cpu, mem = asks[i % len(asks)]
        j = mock.service_job(k, cpu=cpu, mem=mem, batch=True)
        j.id = j.name = f"{tag}-{i}"
        jobs.append(j)
    return jobs


def big_mesh_path(torch, shards, n_nodes, n_jobs, k, device="cuda"):
    """Step 6: the C2M and tpu-solve jobs through Harness("cuda") with a
    fresh service on an explicit mesh of ``shards`` shards of one card (a
    one-shard mesh too: the sharded kernels at n_loc = N_pad), each
    launch's inputs copied (capture_into). Returns (the launch counts,
    the copied B13 and B14 launches, the service's stats)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import solver
    from nomad_tpu_torch.tensor.solver import batch_member, open_batch
    from nomad_tpu_torch.testing import Harness

    from nomad_tpu_torch.tensor.sharding import NodeMesh

    if device == "cpu":
        dev, mesh = torch.device("cpu"), NodeMesh(["cpu"] * shards)
    else:
        dev, mesh = (torch.device("cuda", torch.cuda.current_device()),
                     mesh_of(shards))
    svc = solver.BulkSolverService(dev, mesh=mesh)
    key = str(dev)
    old = solver._services.get(key)
    solver._services[key] = svc
    bulk, joint = [], []
    real_b, real_j = (solver.solve_bulk_multi_sharded,
                      solver.solve_batch_sharded)
    h = Harness(device=device)
    mock.build_nodes(h.store, n_nodes, seed=0)
    c2m = big_jobs(mock, n_jobs, k, f"mesh{shards}-c2m")
    solve = big_jobs(mock, n_jobs, k, f"mesh{shards}-solve", SOLVE_ASKS)
    for j in c2m + solve:
        h.store.upsert_job(j)
    tpu_b = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    tpu_s = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_SOLVE)

    def member(ctx, ev):
        with batch_member(ctx):
            h.process(ev, tpu_s)

    try:
        solver.solve_bulk_multi_sharded = capture_into(torch, bulk, real_b)
        solver.solve_batch_sharded = capture_into(torch, joint, real_j)
        _ext.COUNTS.reset()
        with ThreadPoolExecutor(THREADS) as pool:
            for f in [pool.submit(h.process, mock.eval_for(j), tpu_b)
                      for j in c2m]:
                f.result()
        with ThreadPoolExecutor(MINI_BATCH) as pool:
            evals = [mock.eval_for(j) for j in solve]
            for b in range(0, len(evals), MINI_BATCH):
                batch = evals[b:b + MINI_BATCH]
                ctx = open_batch(len(batch))
                for f in [pool.submit(member, ctx, ev) for ev in batch]:
                    f.result()
        counts = _ext.COUNTS.snapshot()
    finally:
        solver.solve_bulk_multi_sharded = real_b
        solver.solve_batch_sharded = real_j
        svc.stop()
        if old is None:
            solver._services.pop(key, None)
        else:
            solver._services[key] = old
    path_gates(h, c2m + solve, 2 * n_jobs * k,
               f"big_cluster mesh S={shards}")
    return counts, bulk, joint, dict(svc.stats)


def big_replay(torch, what, b1, b11f, b11g, b9, b56, bulk, joint):
    """Every captured launch of the big cluster's paths against its plain
    version on the card: B1 (counts and carry), the fused scan (B11' and
    B11) and the generic scan (B11), B9 (choices exact, scores within
    SCORE_TOL), solve_batch (B5, the pick, B1 and B4's fold inside it),
    B13 and B14 (with B15's fold). Each must also equal the path's own
    output. Returns the replay counts and the largest B9 score error."""
    from nomad_tpu_torch.tensor import batch_solver as bs
    from nomad_tpu_torch.tensor import kernels
    from nomad_tpu_torch.tensor import sharding as sh
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)

    for i, (before, args, g, used, cnt) in enumerate(b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"{what}: B1 launch {i} differs from its "
                                 f"plain version or the path's output")
    for form, calls, fn, ref in (
            ("fused", b11f, kernels.solve_bulk_fused,
             kernels.solve_bulk_fused_ref),
            ("generic", b11g, kernels.solve_bulk, kernels.solve_bulk_ref)):
        for i, (args, kw, out) in enumerate(calls):
            got, want = fn(*args, **kw), ref(*args, **kw)
            if not (torch.equal(got, want) and torch.equal(got, out)):
                raise AssertionError(f"{what}: {form} bulk scan {i} differs "
                                     f"from its plain version or the path")
    err = 0.0
    for i, (packed, out) in enumerate(b9):
        got = kernels.solve_task_group_fused(*packed)
        want = kernels.solve_task_group_fused_ref(*packed)
        if not (torch.equal(got[:2], want[:2]) and torch.equal(got, out)):
            raise AssertionError(f"{what}: B9 launch {i} differs from its "
                                 f"plain version or the path's output")
        err = max(err, score_err(got[2], want[2], f"{what} B9 {i}"))
    for i, (args, kw) in enumerate(b56):
        got = bs.solve_batch(args[0].clone(), *args[1:], **kw)
        want = bs.solve_batch_ref(args[0].clone(), *args[1:], **kw)
        for name, x, y in zip(("used", "counts", "info"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: joint launch {i}: "
                                     f"solve_batch {name} differs from the "
                                     f"plain version")
    for kind, calls, fn, ref in (
            ("B13", bulk, sh.solve_bulk_multi_sharded,
             sh.solve_bulk_multi_sharded_ref),
            ("B14", joint, sh.solve_batch_sharded,
             sh.solve_batch_sharded_ref)):
        for i, (mesh, args, kw, out) in enumerate(calls):
            got = fn(mesh, *clone_parts(args), **kw)
            want = ref(mesh, *clone_parts(args), **kw)
            pairs = [(sh.gather_rows(got[0]), sh.gather_rows(want[0])),
                     (sh.gather_rows(got[1], dim=1),
                      sh.gather_rows(want[1], dim=1)),
                     (got[2], want[2]),
                     (sh.gather_rows(out[1], dim=1),
                      sh.gather_rows(got[1], dim=1))]
            if kind == "B14":
                pairs.append((got[3], want[3]))
            if max_diff(pairs):
                raise AssertionError(f"{what}: {kind} launch {i} (S "
                                     f"{mesh.size}) differs from its plain "
                                     f"version or the path's output")
    torch.cuda.synchronize()
    return {"bulk_fill": len(b1), "bulk_scan_fused": len(b11f),
            "bulk_scan_generic": len(b11g), "solve_task_group": len(b9),
            "solve_batch": len(b56), "bulk_shard": len(bulk),
            "joint_shard": len(joint)}, err


def big_parity(card, n_nodes, large_k, k):
    """Job 0 of step 2 (one group of ``large_k``) and a tpu-solve wave of
    BIG_PARITY_SOLVE jobs x ``k`` through Harness on the card and on the
    CPU, each on a fresh store of the same nodes with pinned ids: the
    same per-node counts (fingerprint)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor.solver import get_service
    from nomad_tpu_torch.testing import Harness

    prints, walls = {}, {}
    for device in ("cuda", "cpu"):
        for alg, jobs in (
                (enums.SCHED_ALG_TPU_BINPACK,
                 big_jobs(mock, 1, large_k, "parity-large")),
                (enums.SCHED_ALG_TPU_SOLVE,
                 big_jobs(mock, BIG_PARITY_SOLVE, k, "parity-solve",
                          SOLVE_ASKS))):
            h = Harness(device=device)
            mock.build_nodes(h.store, n_nodes, seed=0)
            cfg = SchedulerConfiguration(scheduler_algorithm=alg)
            t0 = time.perf_counter()
            for i, j in enumerate(jobs):
                h.store.upsert_job(j)
                h.process(mock.eval_for(j, id=f"{j.id}-ev-{i}"), cfg)
            walls[(device, alg)] = time.perf_counter() - t0
            prints[(device, alg)] = fingerprint(h, jobs)
            get_service(device).stop()
    for alg in (enums.SCHED_ALG_TPU_BINPACK, enums.SCHED_ALG_TPU_SOLVE):
        if prints[("cuda", alg)] != prints[("cpu", alg)]:
            raise AssertionError(f"big_cluster: card and CPU placements "
                                 f"differ under {alg}")
    print(f"parity      card == CPU at {n_nodes} nodes on one {large_k}-alloc "
          f"group (fused scan) and {BIG_PARITY_SOLVE} tpu-solve jobs x {k} "
          f"(the CPU's plain versions {walls[('cpu', 'tpu-binpack')]:.2f} / "
          f"{walls[('cpu', 'tpu-solve')]:.2f} s)")


def phase_big_cluster(torch, card, device="cuda", n_nodes=BIG_NODES,
                      n_jobs=BIG_JOBS, k=K, large_k=LARGE_K,
                      n_large=BIG_LARGE_JOBS, reader_k=BIG_READER_K,
                      svc_k=BIG_SVC_K,
                      workers=SERVER_WORKERS, mesh_jobs=BIG_MESH_JOBS,
                      shards=BIG_SHARDS, parity=True):
    """A 20,000-node cluster (N_pad 32,768) through the port's Server
    (``--big-cluster`` runs it alone): 1. ``n_jobs`` batch jobs x ``k``
    under "tpu-binpack" (B1); 2. ``n_large`` groups of ``large_k`` (one
    solve_bulk_fused each: B11' then B11); 3. one group of ``reader_k``
    reading a multi-node-reader CSI volume, its mask per eval (the
    generic solve_bulk: B11 with the eval's permutation); 4. a service
    group of ``svc_k`` with a rack spread (B9); 5. ``n_jobs`` batch jobs
    x ``k`` under "tpu-solve" (B5 and the pick, B1 and B4 inside
    solve_batch); then 6. the node-sharded service with an explicit mesh
    of each of ``shards`` on one card, C2M and tpu-solve jobs (B13, B14,
    B15). Gates: placed equals asked for every job, no node over
    capacity, every captured launch of B1, B11, B11', B9, B5 and the pick
    (in solve_batch), B13, B14 and B15 exact against its plain version,
    no plain version on CUDA, every kernel of the path launched; then
    card == CPU on job 0 of step 2 and a tpu-solve wave (big_parity).
    Returns (the launch counts of the run, its record)."""
    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.structs import Spread, Volume, VolumeRequest
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import placer, solver

    what = "big_cluster"
    t_phase = time.perf_counter()
    tpu_b = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK)
    tpu_s = SchedulerConfiguration(
        scheduler_algorithm=enums.SCHED_ALG_TPU_SOLVE)
    srv = Server(ServerConfig(
        num_workers=workers, eval_batch_size=1, device=device,
        sched_config=tpu_b, nack_timeout=900.0,
        failed_eval_followup_delay=3600.0, failed_eval_unblock_interval=0.5,
        **BENCH_SAFE))
    svc = solver.get_service(srv.device)
    nodes = _Nodes()
    mock.build_nodes(nodes, n_nodes, seed=0)
    b1, b11f, b11g, b9, b56 = [], [], [], [], []
    real = (solver.solve_bulk_multi, placer.solve_bulk_fused,
            placer.solve_bulk, placer.solve_task_group_fused,
            solver.solve_batch)

    def cap_b1(used, *args, g):
        before, keep = used.clone(), [a.clone() for a in args]
        out = real[0](used, *args, g=g)
        b1.append((before, keep, g, out[0].clone(), out[1].clone()))
        return out

    def cap_scan(into, fn):
        def run(*args, **kw):
            keep = [a.clone() if torch.is_tensor(a) else a for a in args]
            out = fn(*args, **kw)
            into.append((keep, dict(kw), out.clone()))
            return out
        return run

    def cap_b9(*packed):
        keep = [t.clone() for t in packed]
        out = real[3](*packed)
        b9.append((keep, out.clone()))
        return out

    def cap_b56(*args, **kw):
        b56.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                    dict(kw)))
        return real[4](*args, **kw)

    steps = {}
    large = big_jobs(mock, n_large, large_k, "big-large")
    reader = big_jobs(mock, 1, reader_k, "big-reader")[0]
    reader.task_groups[0].volumes = {"shared": VolumeRequest(
        name="shared", type="csi", source="big-shared", read_only=True,
        access_mode="multi-node-reader-only")}
    spread = mock.service_job(svc_k, cpu=100, mem=64, spreads=[
        Spread(attribute="${attr.rack}", weight=50)])
    spread.id = spread.name = "big-spread"
    plan = (("1 tpu-binpack", tpu_b, big_jobs(mock, n_jobs, k, "big-c2m")),
            ("2 large groups", tpu_b, large),
            ("3 reader group", tpu_b, [reader]),
            ("4 spread group", tpu_b, [spread]),
            ("5 tpu-solve", tpu_s, big_jobs(mock, n_jobs, k, "big-solve",
                                           SOLVE_ASKS)))
    try:
        srv.start()
        t0 = time.perf_counter()
        srv.register_nodes(nodes)
        nodes_s = time.perf_counter() - t0
        srv.register_volume(Volume(id="big-shared", name="big-shared",
                                   access_mode="multi-node-reader-only"))
        solver.solve_bulk_multi = cap_b1
        placer.solve_bulk_fused = cap_scan(b11f, real[1])
        placer.solve_bulk = cap_scan(b11g, real[2])
        placer.solve_task_group_fused = cap_b9
        solver.solve_batch = cap_b56
        _ext.COUNTS.reset()
        for name, cfg, jobs in plan:
            srv.set_scheduler_config(cfg)
            t0 = time.perf_counter()
            for j in jobs:
                srv.register_job(j)
            _drain(srv, f"{what} step {name}")
            steps[name] = {"jobs": len(jobs), "wall_s":
                           time.perf_counter() - t0}
        counts = _ext.COUNTS.snapshot()
        applier = dict(srv.plan_applier.stats)
    finally:
        (solver.solve_bulk_multi, placer.solve_bulk_fused, placer.solve_bulk,
         placer.solve_task_group_fused, solver.solve_batch) = real
        srv.stop()
        svc.stop()
    fails = []
    snap = srv.store.snapshot()
    try:
        for _, _, jobs in plan:
            for j in jobs:
                live = sum(1 for a in snap.allocs_by_job(j.id)
                           if not a.terminal_status())
                if live != j.task_groups[0].count:
                    fails.append(f"{j.id} placed {live} of "
                                 f"{j.task_groups[0].count}")
        statuses = Counter(e.status for e in snap.evals())
    finally:
        snap.close()
    over = _over_capacity(srv.store)
    if over:
        fails.append(f"{over} nodes over capacity")
    launched = dict(counts["launches"])
    if any(counts["plain_on_cuda"].values()):
        fails.append(f"plain versions ran on CUDA: {counts['plain_on_cuda']}")
    need = ("bulk_fill", "bulk_scan", "tie_perm", "solve_task_group",
            "auction", "batch_pick", "scatter_add")
    if device != "cpu":
        fails += [f"{n} never launched" for n in need if not launched.get(n)]
        # an eval whose plan the applier rejects in part runs again
        if (len(b11f) < n_large or len(b11g) < 1
                or launched.get("tie_perm") != len(b11f)
                or launched.get("bulk_scan") != len(b11f) + len(b11g)):
            fails.append(f"bulk scans: fused {len(b11f)}, generic "
                         f"{len(b11g)}, launched B11 "
                         f"{launched.get('bulk_scan')}, B11' "
                         f"{launched.get('tie_perm')}")
        if (len(b56) != launched["auction"]
                or len(b1) != launched["bulk_fill"] - launched["auction"]
                or len(b9) != launched["solve_task_group"]):
            fails.append(f"captured B1 {len(b1)}, joint {len(b56)}, B9 "
                         f"{len(b9)} of {launched}")
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    print(f"{what:<11} [{card}] {n_nodes} nodes (N_pad "
          f"{1 << (n_nodes - 1).bit_length()}) through register_nodes in "
          f"{nodes_s:.2f} s, {workers} workers; steps "
          + "; ".join(f"{n} {v['jobs']} job(s) {v['wall_s']:.3f} s"
                      for n, v in steps.items())
          + f"; every job placed, 0 nodes over capacity; evals "
          f"{dict(statuses)}; the applier rejected "
          f"{applier['nodes_rejected']} nodes ({applier['partial_commits']} "
          f"partial commits); launches {launched}")
    # 6. the node-sharded service on one card
    mesh = {}
    bulk, joint = [], []
    for s_n in shards:
        m_counts, m_bulk, m_joint, stats = big_mesh_path(
            torch, s_n, n_nodes, mesh_jobs, k, device)
        m_l = m_counts["launches"]
        if any(m_counts["plain_on_cuda"].values()):
            raise AssertionError(f"{what} mesh S={s_n}: plain versions ran "
                                 f"on CUDA: {m_counts['plain_on_cuda']}")
        if device != "cpu" and not (m_l["bulk_shard"] == len(m_bulk) >= 1
                                    and m_l["joint_shard"] == len(m_joint)
                                    >= 1 and m_l["scatter_shard"] >= 1):
            raise AssertionError(f"{what} mesh S={s_n}: launches {m_l}, "
                                 f"copied B13 {len(m_bulk)}, B14 "
                                 f"{len(m_joint)}")
        for name, v in m_l.items():
            launched[name] = launched.get(name, 0) + v
        mesh[str(s_n)] = {"launches": {n: v for n, v in m_l.items() if v},
                          "allgathers": stats["allgathers"]}
        bulk += m_bulk
        joint += m_joint
    replays, err = big_replay(torch, what, b1, b11f, b11g, b9, b56, bulk,
                              joint)
    print(f"{what:<11} [{card}] mesh on one card at S {shards} "
          f"({mesh_jobs} C2M and {mesh_jobs} tpu-solve jobs x {k} each): "
          f"{mesh}; replays exact: {replays} (B9 scores within {SCORE_TOL}, "
          f"max {err:.3g})")
    if parity:
        big_parity(card, n_nodes, large_k, k)
    rec = {"nodes": n_nodes, "n_pad": 1 << (n_nodes - 1).bit_length(),
           "steps": steps, "register_nodes_s": nodes_s,
           "nodes_rejected": applier["nodes_rejected"],
           "partial_commits": applier["partial_commits"],
           "evals": dict(statuses), "mesh": mesh, "replays": replays,
           "b9_max_score_err": err,
           "launches": {n: v for n, v in launched.items() if v},
           "phase_wall_s": time.perf_counter() - t_phase, "card": card}
    return launched, rec


# ---------------------------------------------------------------------------
# "columns": groups past the kernels' narrow caps (8 resource columns, 8
# spreads, 8 distinct_property constraints), which take their wide
# instances
# ---------------------------------------------------------------------------

# six device groups a node, (vendor, type, name), 1 to 4 instances each
COL_GROUPS = (("nvidia", "gpu", "a100"), ("nvidia", "gpu", "t4"),
              ("amd", "gpu", "mi100"), ("intel", "fpga", "arria10"),
              ("xilinx", "fpga", "u250"), ("mellanox", "nic", "cx6"))
# the value counts of the node meta keys s0..s11 (spread attributes) and
# p0..p8 (distinct_property attributes)
COL_SPREAD_VALUES = (20, 4, 6, 8, 10, 12, 16, 24, 28, 32, 5, 7)
COL_PROP_VALUES = (32, 8, 16, 24, 12, 20, 28, 6, 10)
# the spreads with explicit targets (an equal share of each value)
COL_TARGETED = (1, 4, 7, 10)
COL_K = (512, 512, 256)
# the widths each wide kernel is held at beside its plain version
COL_DIMS = (9, 12, 16, 33)
COL_SPREADS = (9, 16, 33)
COL_PROPS = (9, 16, 33)


def columns_nodes(pkg, n_nodes: int, seed: int = 0):
    """The "columns" nodes, built from ``pkg`` (its ``mock`` and its
    ``Group`` and ``Numa`` classes: NodeDeviceResource and NumaNode):
    16,000 or 32,000 MHz and 64 GiB, 8 or 16 cores in two NUMA domains,
    the six COL_GROUPS with 1 to 4 instances each by node (so the device
    counts and the cores bind before cpu), and meta s0..s11 (a value
    drawn of COL_SPREAD_VALUES) and p0..p8 (value i mod
    COL_PROP_VALUES, so every value of p0 holds a value of p1)."""
    rng = random.Random(seed)
    out = []
    for i in range(n_nodes):
        n = pkg.mock.node()
        n.name = f"col-{i}"
        n.resources.cpu = rng.choice([16000, 32000])
        n.resources.memory_mb = 65536
        cores = rng.choice([8, 16])
        n.resources.total_cores = cores
        n.resources.numa = [pkg.Numa(id=0, cores=list(range(cores // 2))),
                            pkg.Numa(id=1,
                                     cores=list(range(cores // 2, cores)))]
        n.resources.devices = [
            pkg.Group(vendor=v, type=t, name=m,
                      instance_ids=[f"{n.name}-{m}-{k}"
                                    for k in range(rng.randint(1, 4))])
            for v, t, m in COL_GROUPS]
        n.meta.update({f"s{k}": f"v{rng.randrange(c)}"
                       for k, c in enumerate(COL_SPREAD_VALUES)})
        n.meta.update({f"p{k}": f"v{i % c}"
                       for k, c in enumerate(COL_PROP_VALUES)})
        n.compute_class()
        out.append(n)
    return out


def columns_limits(step: int, count: int) -> dict:
    """{p key: limit} of a step's distinct_property constraints: p0 (and
    in step 2 p1) at the count over its values, rounded up, so every
    value fills to its limit; the others at the count."""
    keys = range(9) if step == 2 else (0, 2)
    return {k: (-(-count // COL_PROP_VALUES[k])
                if k == 0 or (step == 2 and k == 1) else count)
            for k in keys}


def columns_jobs(pkg, counts=COL_K, tag="col"):
    """The phase's three groups, built from ``pkg`` (its ``mock`` and its
    ``Ask``, ``Spread``, ``SpreadTarget`` and ``Constraint`` classes),
    cpu 200 and mem 256 an alloc:
    1. counts[0] allocs asking one instance of each COL_GROUPS group and
       one reserved core, spread over s0: d = 11 (4 + 6 + 1);
    2. counts[1] allocs spread over s0..s11 (COL_TARGETED with explicit
       targets, an equal share of each value; the rest even) with
       distinct_property on p0..p8 (columns_limits: p0 and p1 bind):
       d = 4, s = 12, p = 9;
    3. counts[2] allocs asking the first five groups and a core, spread
       over s0..s8, distinct_property on p0 (binding) and p2: d = 10,
       s = 9, p = 2."""
    out = []
    for step, count in enumerate(counts, start=1):
        j = pkg.mock.job()
        j.id = j.name = f"{tag}-{step}"
        tg = j.task_groups[0]
        tg.count = count
        res = tg.tasks[0].resources
        res.cpu, res.memory_mb = 200, 256
        if step != 2:
            groups = COL_GROUPS if step == 1 else COL_GROUPS[:5]
            res.devices = [pkg.Ask(name=f"{v}/{t}/{m}", count=1)
                           for v, t, m in groups]
            res.cores = 1
        spreads = []
        for k in range({1: 1, 2: 12, 3: 9}[step]):
            c = COL_SPREAD_VALUES[k]
            targets = []
            if step > 1 and k in COL_TARGETED:
                share = [100 // c + (1 if t < 100 % c else 0)
                         for t in range(c)]
                targets = [pkg.SpreadTarget(value=f"v{t}", percent=share[t])
                           for t in range(c)]
            spreads.append(pkg.Spread(attribute=f"${{meta.s{k}}}",
                                      weight=25 + 5 * k, targets=targets))
        tg.spreads = spreads
        if step > 1:
            tg.constraints = list(tg.constraints) + [
                pkg.Constraint(f"${{meta.p{k}}}", str(lim),
                               "distinct_property")
                for k, lim in columns_limits(step, count).items()]
        out.append(j)
    return out


def columns_gates(snap, nodes, jobs, what: str) -> dict:
    """Over a store snapshot: every alloc of the jobs live exactly once
    (its count of live allocs, each id once); no node over capacity in
    any column: usage rows recomputed from the live allocs against
    capacity, device instances and cores recomputed from them, each
    instance one of its node's and held once, cores within the node's;
    every distinct_property count within its limit. A spread is a score,
    not a limit (its targets bias the choice; the reference guarantees
    no count), so for each spread with explicit targets the gate holds
    that its counts, recomputed from the store, cover the group and the
    record reports each value's excess over its desired count (rounded
    up). Returns the per-job property maxima and spread excesses."""
    from collections import defaultdict

    by_id = {n.id: n for n in nodes}
    row = {n.id: i for i, n in enumerate(nodes)}
    cap = np.stack([n.available_vec() for n in nodes])
    usage = np.zeros_like(cap)
    insts = defaultdict(list)
    cores = defaultdict(list)
    for a in snap.allocs():
        if a.terminal_status():
            continue
        usage[row[a.node_id]] += a.allocated_vec
        insts[a.node_id].extend(i for v in a.allocated_devices.values()
                                for i in v)
        cores[a.node_id].extend(a.allocated_cores)
    fails = []
    over = int((usage > cap).any(axis=1).sum())
    for nid, held in insts.items():
        owned = {i for g in by_id[nid].resources.devices
                 for i in g.instance_ids}
        if len(held) != len(set(held)) or not set(held) <= owned:
            over += 1
    for nid, held in cores.items():
        if (len(held) != len(set(held))
                or len(held) > by_id[nid].resources.total_cores):
            over += 1
    if over:
        fails.append(f"{over} nodes over capacity (columns, instances or "
                     f"cores)")
    stats = {}
    for j in jobs:
        tg = j.task_groups[0]
        live = [a for a in snap.allocs_by_job(j.id)
                if not a.terminal_status()]
        if len(live) != tg.count or len({a.id for a in live}) != len(live):
            fails.append(f"{j.id}: {len(live)} live of {tg.count}")
        asks = len(tg.tasks[0].resources.devices)
        short = sum(1 for a in live
                    if sum(len(v) for v in a.allocated_devices.values())
                    != asks
                    or len(a.allocated_cores) != tg.tasks[0].resources.cores)
        if short:
            fails.append(f"{j.id}: {short} allocs without their instances "
                         f"and cores")
        worst = {}
        for c in tg.constraints:
            if c.operand != "distinct_property":
                continue
            key = c.ltarget[len("${meta."):-1]
            seen = Counter(by_id[a.node_id].meta[key] for a in live)
            most = max(seen.values()) if seen else 0
            worst[key] = f"{most}/{c.rtarget}"
            if most > int(c.rtarget):
                fails.append(f"{j.id}: {key} value held {most} times, "
                             f"limit {c.rtarget}")
        for sp in tg.spreads:
            if not sp.targets:
                continue
            key = sp.attribute[len("${meta."):-1]
            seen = Counter(by_id[a.node_id].meta[key] for a in live)
            want = {t.value: -(-tg.count * t.percent // 100)
                    for t in sp.targets}
            if sum(seen.values()) != len(live):
                fails.append(f"{j.id}: spread {key} counts {dict(seen)} do "
                             f"not cover the group")
            worst[key] = max((seen[v] - want.get(v, 0) for v in seen),
                             default=0)
        stats[j.id] = worst
    if fails:
        raise AssertionError(f"{what}: " + "; ".join(fails))
    return stats


# (d, s, p) of each "columns" step's B9 launch
COL_SHAPES = {1: (11, 1, 0), 2: (4, 12, 9), 3: (10, 9, 2)}


def columns_pkg():
    """The port's classes for columns_nodes and columns_jobs."""
    import types

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget
    from nomad_tpu_torch.structs.resources import (NodeDeviceResource,
                                                   NumaNode, RequestedDevice)

    return types.SimpleNamespace(
        mock=mock, Group=NodeDeviceResource, Numa=NumaNode,
        Ask=RequestedDevice, Spread=Spread, SpreadTarget=SpreadTarget,
        Constraint=Constraint)


def wide_solve_args(rng, d: int, s: int, p: int, n: int = CFG3_PAD,
                    real: int = CFG3_NODES):
    """One task group's solve at the cfg3 width past the narrow caps, as
    solve_task_group's 26 positional arguments: cfg3's four columns and
    d - 4 device and core count columns with a device-affinity sub-score;
    s spreads over 4 to 31 of 32 values (every fourth
    with explicit targets, one a zero; every third missing on every 13th
    node); p distinct_property constraints over 3 to 22 of 24 values
    (the first at its fair share of the group, so it binds; the others
    at twice that); 500 of 512 steps active, 40 penalty steps,
    affinities and a tie_perm."""
    k_pad, v, vd = 512, 32, 24
    avail = np.zeros((n, 4))
    avail[:real, 0] = rng.choice([8000, 16000, 32000], real)
    avail[:real, 1] = rng.choice([16384, 32768, 65536], real)
    avail[:real, 2:] = (102400, 12001)
    used = np.zeros((n, 4))
    fill = rng.integers(0, 30, real)
    used[:real, :3] = fill[:, None] * np.array([100, 64, 300])
    ask, dev_aff = np.array([100.0, 64.0, 300.0, 0.0]), np.zeros(n)
    if d > 4:
        # device_columns' shape with one node in 50 lacking a group (at d
        # 33 its one in five would leave no node that fits)
        e = d - 4
        cap = np.zeros((n, e))
        cap[:real] = rng.choice([4, 8, 8, 16], (real, e)) * (
            rng.random((real, e)) > 0.02)
        cap[:real, -1] = 16
        xused = np.minimum(cap, rng.integers(0, 4, (n, e)))
        avail = np.concatenate([avail, cap], axis=1)
        used = np.concatenate([used, xused], axis=1)
        ask = np.concatenate([ask, [1.0] * (e - 1) + [2.0]])
        dev_aff[:real] = rng.choice([0.0, 0.0, 0.5, 1.0, -0.25], real)
    feas = np.arange(n) < real
    aff = np.zeros(n)
    aff[:real] = rng.choice([0.0, 0.0, 0.25, -0.25], real)
    ptg = np.zeros(n)
    ptg[:real] = rng.integers(0, 3, real) * (rng.random(real) < 0.1)
    pen = np.full(k_pad, -1)
    pen[rng.integers(0, CFG3_K, 40)] = rng.integers(0, real, 40)
    active = np.arange(k_pad) < CFG3_K
    vals = 4 + (np.arange(s) * 5) % 28
    svid = np.array([(np.arange(n) + k) % vals[k] for k in range(s)],
                    dtype=float).reshape(s, n)
    sok = np.tile(feas, (s, 1))
    sok[2::3, ::13] = False
    scnt = rng.integers(0, 4, (s, v)) * (np.arange(v)[None, :] < vals[:, None])
    sdes = np.full((s, v), np.nan)
    has_t = np.arange(s) % 4 == 0
    for k in np.flatnonzero(has_t):
        sdes[k, :vals[k]] = rng.integers(5, 40, vals[k])
        sdes[k, 0] = 0.0
    weight = rng.integers(10, 60, s) / 100.0
    dvals = 3 + (np.arange(p) * 7) % 20
    dvid = np.array([(np.arange(n) + 3 * k) % dvals[k] for k in range(p)],
                    dtype=float).reshape(p, n)
    dok = np.tile(np.arange(n) < real - 5, (p, 1))
    dcnt = rng.integers(0, 2, (p, vd)) * (np.arange(vd)[None, :]
                                          < dvals[:, None])
    dlim = np.ceil(2.0 * CFG3_K / dvals)
    if p:
        dlim[0] = np.ceil(CFG3_K / dvals[0]) + 1
    return (avail, used, ptg, ptg.copy(), ask, feas, aff, dev_aff, pen,
            active, svid, sok, scnt, sdes, has_t, weight, dvid, dok, dcnt,
            dlim, -1.0, float(CFG3_K), False, False, False,
            rng.permutation(n))


def wide_b11_inputs(rng, d: int, s: int, n_pad: int = N_PAD):
    """b11_inputs' "spreads" case (the generic scan, k 40,000; at N_pad
    ``n_pad``) past the narrow caps: d - 4 count columns (8 to 64 a node,
    0 to 7 used, an ask of 1: they bind the caps) and s spread tables
    over 32 values, every fourth with explicit targets and a zero."""
    f = np.float32
    form, args, scalars = b11_inputs(rng, "spreads", n_pad)
    n = args[0].shape[0]
    real = int((args[0][:, 0] > 0).sum())
    if d > 4:
        xcap = np.zeros((n, d - 4), f)
        xcap[:real] = rng.integers(8, 65, (real, d - 4))
        xused = np.zeros((n, d - 4), f)
        xused[:real] = rng.integers(0, 8, (real, d - 4))
        args[0] = np.concatenate([args[0], xcap], axis=1)
        args[1] = np.concatenate([args[1], xused], axis=1)
        args[2] = np.concatenate([args[2], np.ones(d - 4, f)])
    if s != 2:
        v = 32
        args[8] = rng.integers(0, v, (s, n)).astype(np.int32)
        args[9] = rng.random((s, n)) < 0.9
        args[10] = rng.integers(0, 50, (s, v)).astype(np.int32)
        args[11] = np.full((s, v), np.nan, f)
        args[12] = np.arange(s) % 4 == 0
        for k in np.flatnonzero(args[12]):
            args[11][k] = rng.integers(0, 400, v)
            args[11][k, 3] = 0.0
        args[13] = np.full(s, 1.0 / s, f)
    return form, args, scalars


def widen_preempt(rng, host, d: int):
    """B7's inputs at cfg4's shape with d - 4 more count columns: 4 to 16
    a node, all but 0 to 2 used (so requests evict there too), an ask of
    one, and 0 to 2 a victim."""
    avail, used, ask, feas, net_prio, active, v_prio, v_vec, v_elig, \
        v_flag = host
    n, v = v_elig.shape
    e = d - 4
    xcap = rng.integers(4, 17, (n, e)).astype(np.float32)
    xused = np.maximum(xcap - rng.integers(0, 3, (n, e)), 0).astype(
        np.float32)
    xvec = (rng.integers(0, 3, (n, v, e)) * v_elig[:, :, None]).astype(
        np.float32)
    return (np.concatenate([avail, xcap], axis=1),
            np.concatenate([used, xused], axis=1),
            np.concatenate([ask, np.ones(e, np.float32)]), feas, net_prio,
            active, v_prio, np.concatenate([v_vec, xvec], axis=2), v_elig,
            v_flag)


def _events_ms(torch, fn):
    """(fn(), its device time in ms by CUDA events, one run)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _width_rec(ms, plain_ms, b, err) -> dict:
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None, "max_abs_err": err}


def _refuses(torch, what, fn) -> None:
    """fn raises ValueError naming the shared-memory bytes, and nothing
    is launched."""
    from nomad_tpu_torch import _ext

    before = _ext.COUNTS.snapshot()["launches"]
    try:
        fn()
    except ValueError as e:
        if "bytes of shared memory" not in str(e):
            raise
    else:
        raise AssertionError(f"{what}: took a shape past shared memory")
    if _ext.COUNTS.snapshot()["launches"] != before:
        raise AssertionError(f"{what}: launched past shared memory")


def phase_columns_kernels(torch, dev, card, rng) -> dict:
    """B9, B10, B16, B11, B7 and B12 past the narrow caps, each against
    its plain version on the card (the module docstring's widths; B16
    also bit-equal to B9), timed by CUDA events (the kernel a median of
    runs, the plain version once) beside its bound; then each wrapper's
    refusal at the shared-memory limit, before any launch. Returns
    {kernel name: {width: record}}."""
    from nomad_tpu_torch.tensor import kernels
    from nomad_tpu_torch.tensor import sharding as sh

    out = {name: {} for name in ("solve_task_group", "score_nodes",
                                 "solve_task_group_sharded", "bulk_scan",
                                 "preempt_solve", "preempt_pick")}
    widths = ([(f"d{d}", d, 1, 0) for d in COL_DIMS]
              + [(f"s{s}", 4, s, 0) for s in COL_SPREADS]
              + [(f"p{p}", 4, 1, p) for p in COL_PROPS])
    mesh, mesh_plain = mesh_of(PATH_SHARDS), mesh_of(1)
    for key, d, s, p in widths:
        args = tuple(torch.as_tensor(a).to(dev)
                     for a in wide_solve_args(rng, d, s, p))
        packed = kernels.pack_solve_tensors(*args[:25], node_col=args[25])
        b = scan_bound(packed)
        got = kernels.solve_task_group_fused(*packed)
        want, plain_ms = _events_ms(
            torch, lambda: kernels.solve_task_group_fused_ref(*packed))
        if not torch.equal(got[:2], want[:2]):
            raise AssertionError(f"columns B9 {key}: choices or founds "
                                 f"differ from the plain version")
        err = score_err(got[2], want[2], f"columns B9 {key}")
        ms = cuda_time_ms(torch,
                          lambda _: kernels.solve_task_group_fused(*packed),
                          reps=3, warmup=1)
        out["solve_task_group"][key] = _width_rec(ms, plain_ms, b, err)
        out["solve_task_group"][key]["found"] = int(want[1].sum())
        # B10: one placement's scores, the penalty at node 17
        flat = [packed[0]] + list(packed[2:])
        got10 = kernels.score_nodes_packed(*flat, 17)
        want10, plain10 = _events_ms(
            torch, lambda: kernels.score_nodes_packed_ref(*flat, 17))
        err10 = score_err(got10, want10, f"columns B10 {key}")
        ms10 = cuda_time_ms(torch,
                            lambda _: kernels.score_nodes_packed(*flat, 17))
        n = packed[0].shape[0]
        b10 = bound(4 * (sum(t.numel() for t in flat) + n),
                    int((packed[0][:, 2 * d + 2] > 0.5).sum())
                    * (100 + 12 * (s + p)))
        out["score_nodes"][key] = _width_rec(ms10, plain10, b10, err10)
        # B16 at S 4 on one card: bit-equal to B9, and against its plain
        # version (at S 1, the cheapest: the same function)
        got16 = b16_solve(sh, mesh, args)
        if not same_bits(torch, got16, got):
            raise AssertionError(f"columns B16 {key}: differs from B9")
        want16, plain16 = _events_ms(
            torch, lambda: sh.solve_task_group_sharded_ref(
                mesh_plain, sh.shard_solve_args(mesh_plain, args)))
        if not (torch.equal(got16[0], want16[0])
                and torch.equal(got16[1], want16[1])):
            raise AssertionError(f"columns B16 {key}: choices or founds "
                                 f"differ from the plain version")
        err16 = score_err(got16[2], want16[2], f"columns B16 {key}")
        ms16 = cuda_time_ms(
            torch, lambda _: sh.solve_task_group_sharded(mesh, args), reps=3,
            warmup=1)
        out["solve_task_group_sharded"][key] = _width_rec(ms16, plain16, b,
                                                          err16)
    # B11: the generic scan at the "spreads" shape, d and s widths; and
    # at N_pad 64 with 4 spreads, more than its block's 2 warps (the
    # wide instance's value tables)
    for key, d, s, n_pad in ([(f"d{d}", d, 2, N_PAD) for d in COL_DIMS]
                             + [(f"s{s}", 4, s, N_PAD) for s in COL_SPREADS]
                             + [("n64_s4", 4, 4, 64)]):
        form, host, scalars = wide_b11_inputs(rng, d, s, n_pad)
        run = b11_runner(torch, dev, form, host, scalars)
        got = run()
        want, plain_ms = _events_ms(
            torch, b11_runner(torch, dev, form, host, scalars, plain=True))
        if not torch.equal(got, want):
            raise AssertionError(f"columns B11 {key}: counts differ from "
                                 f"the plain version")
        ms = cuda_time_ms(torch, lambda _: run(), reps=3, warmup=1)
        counts = got.cpu().numpy()
        b = b11_bound(host[0].shape[0], d, int(host[3].sum()), counts, s)
        out["bulk_scan"][key] = _width_rec(ms, plain_ms, b, 0.0)
        out["bulk_scan"][key]["placed"] = int(counts.sum())
    # B7 and B12 at cfg4's shape (N_pad 1,024, K 512, V 512)
    for d in COL_DIMS:
        host = widen_preempt(rng, preempt_inputs(
            rng, "main", n_pad=CFG4_NODES, n_real=CFG4_NODES, v=512), d)
        args = on_card(torch, host, dev)
        got = kernels.preempt_solve(*args)
        want, plain_ms = _events_ms(torch,
                                    lambda: kernels.preempt_solve_ref(*args))
        err = check_preempt(torch, got, want, f"columns d{d}")
        ms = cuda_time_ms(torch, lambda _: kernels.preempt_solve(*args),
                          reps=5)
        picks, victims = got[0].cpu().numpy(), got[1].cpu().numpy()
        out["preempt_solve"][f"d{d}"] = dict(
            _width_rec(ms, plain_ms, preempt_bound(host, picks, victims),
                       err), placed=int((picks >= 0).sum()),
            victims=int(victims.sum()))
        pargs = [torch.tensor(a, device=dev) for a in _pick_from(host)]
        got12 = kernels.preempt_pick(*pargs)
        want12, plain12 = _events_ms(
            torch, lambda: kernels.preempt_pick_ref(*pargs))
        if not torch.equal(got12, want12):
            raise AssertionError(f"columns B12 d{d}: picks differ from the "
                                 f"plain version")
        ms12 = cuda_time_ms(torch, lambda _: kernels.preempt_pick(*pargs),
                            reps=5)
        p12 = got12.cpu().numpy()
        out["preempt_pick"][f"d{d}"] = dict(
            _width_rec(ms12, plain12, pick_preempt_bound(host, p12), 0.0),
            placed=int((p12 >= 0).sum()))
    # the one refusal left: tables past a CTA's shared memory
    f32 = torch.float32
    big = [t.to(dev) for t in kernels.pack_solve_tensors(
        *[torch.as_tensor(a) for a in wide_solve_args(
            rng, 4, 4, 0, n=1024, real=1000)[:25]])]
    big[3] = torch.zeros((8, 8192), dtype=f32, device=dev)   # V 8,192
    _refuses(torch, "B9", lambda: kernels.solve_task_group_fused(*big))
    _refuses(torch, "B10", lambda: kernels.score_nodes_packed(
        big[0], *big[2:], -1))
    form, host, scalars = b11_inputs(rng, "spreads")
    host[8] = np.zeros((8, host[0].shape[0]), np.int32)
    host[9] = np.ones((8, host[0].shape[0]), bool)
    host[10] = np.zeros((8, 4096), np.int32)
    host[11] = np.full((8, 4096), np.nan, np.float32)
    host[12], host[13] = np.zeros(8, bool), np.full(8, 0.125, np.float32)
    _refuses(torch, "B11", b11_runner(torch, dev, form, host, scalars))
    sargs = list(wide_solve_args(rng, 4, 4, 0, n=1024, real=1000))
    sargs[12] = np.zeros((4, 8192))
    sargs[13] = np.full((4, 8192), np.nan)
    _refuses(torch, "B16", lambda: sh.solve_task_group_sharded(
        mesh, tuple(torch.as_tensor(a).to(dev) for a in sargs)))
    wide_d = 20000
    _refuses(torch, "B7", lambda: kernels.preempt_solve(
        torch.ones((1, wide_d), device=dev),
        torch.zeros((1, wide_d), device=dev),
        torch.ones(wide_d, device=dev),
        torch.ones(1, dtype=torch.bool, device=dev),
        torch.zeros(1, device=dev), torch.ones(2, dtype=torch.bool,
                                               device=dev), None,
        torch.zeros((1, 1, wide_d), device=dev),
        torch.ones((1, 1), dtype=torch.bool, device=dev),
        torch.zeros((1, 1), dtype=torch.bool, device=dev)))
    many = 929_793
    _refuses(torch, "B12", lambda: kernels.preempt_pick(
        torch.ones((many, 2), device=dev), torch.zeros((many, 2), device=dev),
        torch.zeros((many, 2), device=dev), torch.ones(2, device=dev),
        torch.ones(many, dtype=torch.bool, device=dev),
        torch.zeros(many, device=dev),
        torch.ones(2, dtype=torch.bool, device=dev)))
    for name, recs in out.items():
        print(f"columns    [{card}] {name}: exact against the plain version "
              f"at " + "; ".join(
                  f"{k} kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} "
                  f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}), err "
                  f"{r['max_abs_err']:.3g}" for k, r in recs.items()))
    print(f"columns    [{card}] B9, B10, B11, B16, B7 and B12 refuse tables "
          f"past a CTA's shared memory before any launch")
    return out


def phase_columns(torch, card, device="cuda", n_nodes=N_NODES, counts=COL_K,
                  workers=SERVER_WORKERS, rng=None):
    """The "columns" phase (``--columns`` runs it alone): a fresh port
    Server (``workers`` workers, "tpu-binpack", BENCH_SAFE) on
    columns_nodes' ``n_nodes`` nodes, then columns_jobs' three groups one
    after another, each drained, with every B9 launch's inputs copied and
    timed by CUDA events; the gates of columns_gates after each step, B9
    launched once a capture at COL_SHAPES' (d, s, p), every launch
    replayed exact against solve_task_group_fused_ref (choices and founds
    exact, scores within SCORE_TOL), no plain version on CUDA. Then (with
    ``rng``) phase_columns_kernels. Returns (the launch counts of the
    Server run, the record, the kernels' width records)."""
    from nomad_tpu_torch import _ext
    from nomad_tpu_torch.core.server import Server, ServerConfig
    from nomad_tpu_torch.structs import enums
    from nomad_tpu_torch.structs.operator import SchedulerConfiguration
    from nomad_tpu_torch.tensor import placer, solver
    from nomad_tpu_torch.tensor.kernels import (solve_task_group_fused,
                                                solve_task_group_fused_ref)

    what = "columns"
    t_phase = time.perf_counter()
    pkg = columns_pkg()
    srv = Server(ServerConfig(
        num_workers=workers, eval_batch_size=1, device=device,
        sched_config=SchedulerConfiguration(
            scheduler_algorithm=enums.SCHED_ALG_TPU_BINPACK),
        nack_timeout=900.0, failed_eval_followup_delay=3600.0,
        failed_eval_unblock_interval=0.5, **BENCH_SAFE))
    svc = solver.get_service(srv.device)
    nodes = columns_nodes(pkg, n_nodes)
    jobs = columns_jobs(pkg, counts)
    b9 = []
    real = placer.solve_task_group_fused

    def cap_b9(*packed):
        keep = [t.clone() for t in packed]
        if device == "cpu":
            out = real(*packed)
            ms = 0.0
        else:
            out, ms = _events_ms(torch, lambda: real(*packed))
        b9.append((keep, out.clone(), ms))
        return out

    steps = {}
    try:
        srv.start()
        t0 = time.perf_counter()
        srv.register_nodes(nodes)
        nodes_s = time.perf_counter() - t0
        placer.solve_task_group_fused = cap_b9
        _ext.COUNTS.reset()
        for step, j in enumerate(jobs, start=1):
            first = len(b9)
            t0 = time.perf_counter()
            srv.register_job(j)
            _drain(srv, f"{what} step {step}")
            wall = time.perf_counter() - t0
            snap = srv.store.snapshot()
            try:
                stats = columns_gates(snap, list(snap.nodes()), jobs[:step],
                                      f"{what} step {step}")
            finally:
                snap.close()
            shapes = sorted({((t[0].shape[1] - 6) // 2, t[4].shape[0],
                              t[5].shape[0] // 2) for t, _, _ in b9[first:]})
            if shapes != [COL_SHAPES[step]]:
                raise AssertionError(f"{what} step {step}: B9 at (d, s, p) "
                                     f"{shapes}, not {COL_SHAPES[step]}")
            steps[str(step)] = {
                "allocs": j.task_groups[0].count, "wall_s": wall,
                "b9_launches": len(b9) - first,
                "b9_ms": [r[2] for r in b9[first:]],
                "dpk": dict(zip(("d", "s", "p"), COL_SHAPES[step])),
                "gates": stats[j.id]}
        counts_run = _ext.COUNTS.snapshot()
    finally:
        placer.solve_task_group_fused = real
        srv.stop()
        svc.stop()
    launched = counts_run["launches"]
    if any(counts_run["plain_on_cuda"].values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA: "
                             f"{counts_run['plain_on_cuda']}")
    if device != "cpu" and launched["solve_task_group"] != len(b9):
        raise AssertionError(f"{what}: B9 launched "
                             f"{launched['solve_task_group']}, captured "
                             f"{len(b9)}")
    err, plain_ms, replay_ms = 0.0, [], []
    bounds = [scan_bound(packed) for packed, _, _ in b9]
    for i, (packed, out, _) in enumerate(b9):
        want, pms = ((solve_task_group_fused_ref(*packed), 0.0)
                     if device == "cpu" else
                     _events_ms(torch,
                                lambda: solve_task_group_fused_ref(*packed)))
        if not torch.equal(out[:2], want[:2]):
            raise AssertionError(f"{what} B9 launch {i}: choices or founds "
                                 f"differ from the plain version")
        err = max(err, score_err(out[2], want[2], f"{what} B9 launch {i}"))
        plain_ms.append(pms)
        if device != "cpu":     # the launch again, warm
            replay_ms.append(cuda_time_ms(
                torch, lambda _: solve_task_group_fused(*packed), reps=3,
                warmup=1))
    print(f"{what:<11} [{card}] {n_nodes} nodes (six device groups, cores, "
          f"21 meta attributes) through register_nodes in {nodes_s:.2f} s, "
          f"{workers} workers; "
          + "; ".join(f"step {k} {v['allocs']} allocs at (d, s, p) "
                      f"{tuple(v['dpk'].values())} {v['wall_s']:.3f} s, "
                      f"B9 {v['b9_launches']} launch(es) "
                      f"{[round(x, 4) for x in v['b9_ms']]} ms, "
                      f"gates {v['gates']}" for k, v in steps.items())
          + f"; every alloc live once, no node over capacity in any "
          f"column, every instance and core booked once, the "
          f"distinct_property limits held; B9 replays exact (scores "
          f"within {SCORE_TOL}, max {err:.3g}), warm "
          f"{[round(x, 4) for x in replay_ms]} ms, plain "
          f"{[round(x, 1) for x in plain_ms]} ms, bound "
          f"{[f'{b:.6f} ({by})' for b, by in bounds]} ms; launches "
          f"{ {k: v for k, v in launched.items() if v} }")
    rec = {"nodes": n_nodes, "register_nodes_s": nodes_s, "steps": steps,
           "b9_replay_max_err": err, "b9_plain_ms": plain_ms,
           "b9_warm_ms": replay_ms, "b9_bound_ms": [b for b, _ in bounds],
           "b9_bound_by": [by for _, by in bounds],
           "launches": {k: v for k, v in launched.items() if v},
           "card": card}
    widths = (phase_columns_kernels(torch, torch.device(device), card, rng)
              if rng is not None else {})
    rec["phase_wall_s"] = time.perf_counter() - t_phase
    return launched, rec, widths


CL_CLIENTS = 4           # step (a): the agent's --clients
CL_WORKERS = 4           # ... and --workers
CL_BATCH_MAX = 1024      # the batch job's count: 80% of what the four
CL_BATCH_MIN = 256       # nodes hold, within these bounds (B1 from 256)
CL_RUN_FOR = 0.5         # its mock tasks' run time (s)
CL_GPU_K = 4             # a job of 4 asking one nvidia/gpu each
CL_LOG = "hello from a port client"
CL_DISK = 10             # the batch group's ephemeral disk (MB)
CL_FLEET = 256           # step (b): client agents with C2M's node shapes
CL_FLEET_K = 4000        # C2M's job shape: one batch job of 4,000 (the
                         # card's machine kills a process of a few
                         # thousand threads: the client keeps one thread
                         # a live mock alloc, and none a mock task)
CL_FLEET_RUN_FOR = 0.2
CL_FLEET_SVC_K = 64      # a service group with a rack spread (B9)
CL_FLEET_TTL = 3600.0    # the fleet's heartbeat TTL (s), see clients_fleet

CL_BATCH_HCL = """
job "%s" {
  datacenters = ["dc1"]
  type = "batch"
  group "work" {
    count = %d
    ephemeral_disk { size = %d }
    task "work" {
      driver = "mock"
      config { run_for = %s }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""

CL_EXEC_HCL = """
job "%s" {
  datacenters = ["dc1"]
  type = "%s"
  group "sh" {
    count = 1
    task "sh" {
      driver = "raw_exec"
      config {
        command = "/bin/sh"
        args = ["-c", "%s"]
      }
      resources { cpu = 50 memory = 32 }
    }
  }
}
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gpu_group(torch, device) -> str:
    """The device group the client fingerprints the card as; "" on the
    CPU rehearsal."""
    if device == "cpu":
        return ""
    name = torch.cuda.get_device_name(0).lower().replace(" ", "-")
    return f"nvidia/gpu/{name}"


def _executors(data_dir: str) -> list:
    """The live processes of the executors the agent under ``data_dir``
    started and of their tasks, read from its clients' state files and
    the executors' status files."""
    import glob

    pids = []
    for path in glob.glob(os.path.join(data_dir, "client*",
                                       "client_state.json")):
        with open(path) as f:
            state = json.load(f)
        for rec in state.get("allocs", {}).values():
            for h in (rec.get("handles") or {}).values():
                if not h or not h.get("executor_pid"):
                    continue
                pids.append(int(h["executor_pid"]))
                try:
                    with open(h["status_file"]) as f:
                        pids.append(int(json.load(f).get("task_pid", 0)))
                except (OSError, ValueError):
                    pass
    live = []
    for pid in pids:
        if pid <= 0:
            continue
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            continue
        except PermissionError:
            pass
        live.append(pid)
    return live


def _cli(addr: str, *argv, check=True) -> str:
    """One command of the port's CLI against the agent at ``addr``."""
    out = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch", "--address", addr,
         *argv], cwd=REPO, capture_output=True, text=True, timeout=120)
    if check and out.returncode != 0:
        raise AssertionError(f"clients: `{' '.join(argv)}` exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def clients_agent(torch, card, device="cuda", n_clients=CL_CLIENTS,
                  workers=CL_WORKERS) -> dict:
    """Step (a): the real entry point as a subprocess, driven through
    the port's CLI and ApiClient (see the module docstring)."""
    import shutil
    import tempfile
    import threading

    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.api.codec import to_dict
    from nomad_tpu_torch.structs.job import Job, Task, TaskGroup
    from nomad_tpu_torch.structs.resources import RequestedDevice, Resources

    what = "clients"
    t_step = time.perf_counter()
    data = tempfile.mkdtemp(prefix="chip_smoke_agent_")
    port = _free_port()
    cmd = [sys.executable, "-m", "nomad_tpu_torch", "agent",
           "--clients", str(n_clients), "--workers", str(workers),
           "--algorithm", "tpu-binpack", "--data-dir", data,
           "--port", str(port)]
    if device == "cpu":
        cmd += ["--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    reader = threading.Thread(
        target=lambda: lines.extend(iter(proc.stdout.readline, "")),
        daemon=True)
    reader.start()
    addr = f"http://127.0.0.1:{port}"
    rc = None
    try:
        deadline = time.time() + 180.0
        while not any(ln.startswith("agent started") for ln in lines):
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(f"{what}: the agent did not start: "
                                     f"{''.join(lines)[-3000:]}")
            time.sleep(0.1)
        start_s = time.perf_counter() - t_step
        api = ApiClient(addr, timeout=60.0)
        deadline = time.time() + 60.0
        while len(api.list_nodes()) < n_clients:
            if time.time() > deadline:
                raise AssertionError(f"{what}: {len(api.list_nodes())} of "
                                     f"{n_clients} clients registered")
            time.sleep(0.1)
        nodes = [api.node(n["id"]) for n in api.list_nodes()]
        group = _gpu_group(torch, device)
        for nd in nodes:
            ids = {f"{d['vendor']}/{d['type']}/{d['name']}"
                   for d in nd["resources"]["devices"]}
            if group and group not in ids:
                raise AssertionError(f"{what}: node {nd['id']} carries "
                                     f"{sorted(ids)}, not {group}")
        # what the four fingerprinted nodes hold of the batch job's ask
        # (cpu 50, memory 32, the group's CL_DISK MB of ephemeral disk)
        hold = [int(min((nd["resources"]["cpu"]
                         - nd["reserved"]["cpu"]) // 50,
                        (nd["resources"]["memory_mb"]
                         - nd["reserved"]["memory_mb"]) // 32,
                        (nd["resources"]["disk_mb"]
                         - nd["reserved"]["disk_mb"]) // CL_DISK))
                for nd in nodes]
        count = min(CL_BATCH_MAX, int(0.8 * sum(hold)))
        if count < CL_BATCH_MIN:
            raise AssertionError(f"{what}: the nodes hold {sum(hold)} "
                                 f"allocs, too few for a group of "
                                 f"{CL_BATCH_MIN}")
        print(f"{what:<11} [{card}] agent up in {start_s:.3f} s at {addr}: "
              f"{n_clients} clients fingerprinted as "
              f"{group or 'no card (CPU rehearsal)'}; the nodes hold "
              f"{hold} allocs of cpu 50 / mem 32 / disk {CL_DISK}, the batch "
              f"job asks {count}")

        specs = {"batch": CL_BATCH_HCL % ("cl-batch", count, CL_DISK,
                                          CL_RUN_FOR),
                 "echo": CL_EXEC_HCL % ("cl-echo", "batch",
                                        f"echo {CL_LOG}"),
                 "sleep": CL_EXEC_HCL % ("cl-sleep", "service",
                                         "sleep 600")}
        t0 = time.perf_counter()
        for name, text in specs.items():
            path = os.path.join(data, f"{name}.hcl")
            with open(path, "w") as f:
                f.write(text)
            _cli(addr, "job", "run", path)
        if group:
            gpu = Job(id="cl-gpu", name="cl-gpu", type="service",
                      datacenters=["dc1"], task_groups=[TaskGroup(
                          name="gpu", count=CL_GPU_K, tasks=[Task(
                              name="gpu", driver="mock",
                              config={"run_for": 3600.0},
                              resources=Resources(
                                  cpu=50, memory_mb=32,
                                  devices=[RequestedDevice(
                                      name="nvidia/gpu", count=1)]))])])
            api.register_job(to_dict(gpu))

        def states(job_id):
            return [(a["id"], a["client_status"], a["node_id"])
                    for a in api.job_allocations(job_id)]

        deadline = time.time() + 120.0
        while True:
            batch = states("cl-batch")
            done = sum(1 for _, s, _ in batch if s == "complete")
            echo = states("cl-echo")
            sleep = states("cl-sleep")
            gpus = states("cl-gpu") if group else []
            ok = (len(batch) == count and done == count
                  and [s for _, s, _ in echo] == ["complete"]
                  and [s for _, s, _ in sleep] == ["running"]
                  and (not group or (len(gpus) == CL_GPU_K and all(
                      s == "running" for _, s, _ in gpus))))
            if ok:
                break
            if time.time() > deadline:
                raise AssertionError(
                    f"{what}: batch {done} of {count} complete "
                    f"({Counter(s for _, s, _ in batch)}), echo {echo}, "
                    f"sleep {sleep}, gpu {Counter(s for _, s, _ in gpus)}")
            time.sleep(0.2)
        run_s = time.perf_counter() - t0
        if group:
            held = [api.allocation(a)["allocated_devices"]
                    for a, _, _ in gpus]
            if any(h != {group: ["gpu-0"]} for h in held) or len(
                    {n for _, _, n in gpus}) != CL_GPU_K:
                raise AssertionError(f"{what}: the GPU allocs hold {held} "
                                     f"on {len({n for _, _, n in gpus})} "
                                     f"nodes")
        log = _cli(addr, "alloc", "logs", echo[0][0])
        if log != CL_LOG + "\n":
            raise AssertionError(f"{what}: the log reads back {log!r}")
        status = _cli(addr, "job", "status", "cl-batch")
        if status.count("complete") != count:
            raise AssertionError(f"{what}: `job status` shows "
                                 f"{status.count('complete')} complete")
        metrics = api.metrics()
        launches = {k.rsplit(".", 1)[1]: v for k, v in metrics.items()
                    if k.startswith("nomad.kernel.launches.") and v}
        solver_launches = metrics.get("nomad.solver.launches", 0)
        if not solver_launches or (device != "cpu"
                                   and not launches.get("bulk_fill")):
            raise AssertionError(f"{what}: the agent's metrics show "
                                 f"{solver_launches} solver launches, "
                                 f"kernels {launches}")
        running = _executors(data)
        if not running:
            raise AssertionError(f"{what}: the sleep task's executor is "
                                 f"not running before the stop")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        reader.join(10)
        left = _executors(data)
        if rc != 0 or left or not any(ln.startswith("agent stopped")
                                      for ln in lines):
            raise AssertionError(f"{what}: SIGTERM: exit {rc}, processes "
                                 f"left {left}: {''.join(lines)[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        shutil.rmtree(data, ignore_errors=True)
    rec = {"clients": n_clients, "start_s": start_s, "hold": hold,
           "batch": count, "run_s": run_s,
           "gpu_group": group, "gpu_allocs": len(gpus),
           "solver_launches": solver_launches, "kernel_launches": launches,
           "executors_before_stop": len(running), "exit": rc}
    print(f"{what:<11} [{card}] step (a): {count} batch allocs complete, "
          f"{len(gpus)} GPU allocs running on {group or '-'} each holding "
          f"gpu-0, the raw_exec log read back, in {run_s:.3f} s from "
          f"`job run`; the agent's solver launches {solver_launches}, "
          f"kernels {launches}; SIGTERM: exit {rc}, "
          f"{len(running)} executor processes before it, none after")
    return rec


class _FleetProgress:
    """The fleet's state in one line: each job's allocs by client status,
    the broker's queue, blocked evals, the batcher, the threads."""

    def __init__(self, srv, job_ids, errors=None):
        self.srv = srv
        self.job_ids = job_ids
        self.errors = errors if errors is not None else []
        self.last = time.time()

    def __str__(self):
        import threading

        snap = self.srv.store.snapshot()
        try:
            jobs = {jid: dict(Counter(a.client_status
                                      for a in snap.allocs_by_job(jid)))
                    for jid in self.job_ids}
        finally:
            snap.close()
        return (f"allocs {jobs}; broker {self.srv.broker.stats}; blocked "
                f"{self.srv.blocked.blocked_count()}; batcher "
                f"{self.srv.client_updates.stats}; threads "
                f"{threading.active_count()}; thread errors "
                f"{len(self.errors)} {self.errors[:3]}")

    def show(self, head: str) -> None:
        print(f"{head}: {self}", flush=True)
        self.last = time.time()

    def every(self, seconds: float, head: str) -> None:
        # a line each 10 s at most: it reads every row of both jobs
        if time.time() - self.last >= seconds:
            self.show(head)


def clients_fleet(torch, card, device="cuda", n_clients=CL_FLEET,
                  k=CL_FLEET_K, svc_k=CL_FLEET_SVC_K,
                  workers=SERVER_WORKERS):
    """Step (b): the fleet in-process, through ``cli.build_agent`` (see
    the module docstring): returns the kernels' launch counts of the
    step and its record."""
    import shutil
    import tempfile
    import threading

    from nomad_tpu_torch import _ext, mock
    from nomad_tpu_torch.api import ApiClient
    from nomad_tpu_torch.api.codec import to_dict
    from nomad_tpu_torch.cli import build_agent
    from nomad_tpu_torch.client import ClientConfig
    from nomad_tpu_torch.obs import TRACER
    from nomad_tpu_torch.obs.trace import R_NAME, R_T0, R_T1
    from nomad_tpu_torch.structs import Spread
    from nomad_tpu_torch.tensor import incremental, kernels, placer, solver
    from nomad_tpu_torch.tensor.kernels import (solve_bulk_multi,
                                                solve_bulk_multi_ref)

    what = "clients"
    nodes = _Nodes()
    mock.build_nodes(nodes, n_clients, seed=0)
    for nd in nodes:
        nd.drivers = {"mock": True}
        nd.attributes["driver.mock"] = "1"
    data = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    b1, b9, b4 = [], [], []
    real_b1 = solver.solve_bulk_multi
    real_b9 = placer.solve_task_group_fused

    def cap_b1(used, *args, g):
        before = used.clone()
        keep = [a.clone() for a in args]
        out = real_b1(used, *args, g=g)
        b1.append((before, keep, g, out[0].clone(), out[1].clone()))
        return out

    def cap_b9(*packed):
        snap = [t.clone() for t in packed]
        out = real_b9(*packed)
        b9.append((snap, out.clone()))
        return out

    # an exception that ends a thread (a client's, a runner's) is kept
    # for the failure message: the machine's thread limit shows here
    errors = []
    hook = threading.excepthook
    threading.excepthook = lambda a: errors.append(
        f"{a.thread.name if a.thread else '?'}: {a.exc_type.__name__}: "
        f"{a.exc_value}")
    peak = [threading.active_count()]
    sampling = threading.Event()

    def sample():
        while not sampling.wait(0.05):
            peak[0] = max(peak[0], threading.active_count())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    agent = None
    # what the earlier phases left alive is frozen out of the collector:
    # its passes hold the interpreter lock the fleet's threads wait on
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    try:
        # bench-safe TTL and nack timeout (as the other Server phases):
        # one interpreter runs 256 clients and every runner's threads
        # beside the Server, and under the burst a heartbeat thread or a
        # worker can wait out a long GIL convoy (a 30 s TTL marked nodes
        # down, a 60 s nack timeout redelivered the batch eval); the
        # clients still heartbeat every 3 s
        agent = build_agent(
            workers=workers, algorithm="tpu-binpack", clients=n_clients,
            port=0, data_dir=data, device=device, nodes=nodes,
            client_config=lambda i: ClientConfig(fingerprint_interval=3600.0),
            heartbeat_ttl=CL_FLEET_TTL, gc_interval=3600.0,
            nack_timeout=900.0)
        srv = agent.server
        svc = solver.get_service(srv.device)
        fleet_s = time.perf_counter() - t0
        import resource

        try:
            with open("/proc/sys/kernel/threads-max") as f:
                threads_max = f.read().strip()
        except OSError:
            threads_max = "?"
        print(f"{what:<11} [{card}] step (b): {n_clients} clients up in "
              f"{fleet_s:.3f} s, {threading.active_count()} threads "
              f"(RLIMIT_NPROC {resource.getrlimit(resource.RLIMIT_NPROC)}, "
              f"threads-max {threads_max})", flush=True)
        api = ApiClient(agent.http.address, timeout=120.0)
        if len(api.list_nodes()) != n_clients:
            raise AssertionError(f"{what}: {len(api.list_nodes())} of "
                                 f"{n_clients} clients registered")
        batch = mock.service_job(k, cpu=50, mem=32, batch=True)
        batch.task_groups[0].tasks[0].config = {"run_for": CL_FLEET_RUN_FOR}
        svc_job = mock.service_job(
            svc_k, cpu=50, mem=32,
            spreads=[Spread(attribute="${attr.rack}", weight=50)])
        svc_job.task_groups[0].tasks[0].driver = "mock"
        svc_job.task_groups[0].tasks[0].config = {"run_for": 3600.0}
        batch.task_groups[0].tasks[0].driver = "mock"
        TRACER.clear()
        solver.solve_bulk_multi = cap_b1
        placer.solve_task_group_fused = cap_b9
        with capture_b4(b4):
            _ext.COUNTS.reset()
            sync0 = dict(srv.client_updates.stats)
            hub0 = dict(srv.alloc_sync.stats)
            progress = _FleetProgress(srv, (batch.id, svc_job.id), errors)
            feed = incremental.feed_for(srv.store)

            def catch_up():
                """The twin route's call, as the solver service's resync
                makes it: the device twin caught up with the feed's
                pending rows by one B4 launch (a re-upload past n_pad)."""
                with svc._stream_ctx():
                    feed.device_used(feed._epoch.static_ref, svc.device)

            def rows(jid, status):
                snap = srv.store.snapshot()
                try:
                    return [a for a in snap.allocs_by_job(jid)
                            if a.client_status == status]
                finally:
                    snap.close()

            # the waits count the clients' status writes off the store's
            # commits: reading 4,000 rows a tick from a snapshot would
            # take the interpreter from the clients it waits on
            seen = {}

            def on_commit(_index, events):
                for kind, a in events:
                    if kind == "alloc-client-update":
                        seen[(a.job_id, a.id)] = a.client_status

            def count(jid, status):
                return sum(1 for (j, _), st in list(seen.items())
                           if j == jid and st == status)

            srv.store.add_commit_listener(on_commit)

            def until(pred, what_for, limit=150.0, catch=True):
                deadline = time.time() + limit
                while not pred():
                    if time.time() > deadline:
                        raise AssertionError(f"{what}: {what_for}: "
                                             f"{progress}")
                    progress.every(10.0, f"{what:<11} [{card}] {what_for}")
                    if catch:
                        catch_up()
                    time.sleep(0.25)

            # one job at a time, the B9 group first: a B9 group placed
            # while the bulk group solves is outside the solver service's
            # carry, whose B1 then overfills its nodes until every plan
            # attempt is spent (ROADMAP §C12, the reference's too); the
            # bulk group's first solve resyncs the carry from the store
            api.register_job(to_dict(svc_job))
            _drain(srv, f"{what} service job {progress}", limit=120.0)
            if feed is None or feed._epoch is None:
                raise AssertionError(f"{what}: the feed has no epoch")
            twin0 = feed.stats()
            t_submit = time.time()
            api.register_job(to_dict(batch))
            _drain(srv, f"{what} batch job {progress}", limit=120.0)
            placed_s = time.time() - t_submit
            progress.show(f"{what:<11} [{card}] placed in {placed_s:.3f} s")
            until(lambda: count(batch.id, "complete") == k
                  and count(svc_job.id, "running") == svc_k,
                  "waiting for the completes", limit=300.0)
            done = rows(batch.id, "complete")
            svc_run = rows(svc_job.id, "running")
            if len(done) != k or len(svc_run) != svc_k:
                raise AssertionError(f"{what}: the store holds {len(done)} "
                                     f"complete, {len(svc_run)} running")
            wall = max(a.modify_time for a in done) - t_submit
            # the service job stopped: its 64 allocs' freed capacity, a
            # few rows, reaches the twin in one B4 flush
            catch_up()
            api.deregister_job(svc_job.id)
            until(lambda: count(svc_job.id, "complete") == svc_k,
                  "waiting for the stopped service allocs", catch=False)
            _drain(srv, f"{what} service stop {progress}", limit=60.0)
            flushes = feed.stats()["twin_flushes"]
            catch_up()
            stop_flushed = feed.stats()["twin_flushes"] - flushes
            verified = feed.force_verify()
            counts = _ext.COUNTS.snapshot()
            twin = {key: feed.stats()[key] - twin0[key]
                    for key in ("twin_flushes", "twin_uploads")}
            twin["stop_flush"] = stop_flushed
        solver.solve_bulk_multi = real_b1
        placer.solve_task_group_fused = real_b9
        if not verified or not stop_flushed:
            raise AssertionError(f"{what}: the feed's verify {verified}, "
                                 f"twin {twin}: "
                                 f"{incremental.GLOBAL.violations[-1:]}")
        over = _over_capacity(srv.store)
        if over:
            raise AssertionError(f"{what}: {over} nodes over capacity")
        synced = {key: srv.client_updates.stats[key] - sync0[key]
                  for key in sync0}
        hub = {key: srv.alloc_sync.stats[key] - hub0[key] for key in hub0}
        # every status came from a client: through the batcher, with the
        # task states only a client's task runners write
        if synced["batched_updates"] < k + svc_k or any(
                not a.task_states for a in done + svc_run):
            raise AssertionError(f"{what}: the batcher took {synced}")
        syncs = sorted(1e3 * (r[R_T1] - r[R_T0]) for r in TRACER.spans()
                       if r[R_NAME] == "client.sync")
        feed_stats = feed.stats()
    finally:
        solver.solve_bulk_multi = real_b1
        placer.solve_task_group_fused = real_b9
        if agent is not None:
            t_stop = time.perf_counter()
            agent.stop()
            stop_s = time.perf_counter() - t_stop
        sampling.set()
        sampler.join(5)
        threading.excepthook = hook
        gc.unfreeze()
        shutil.rmtree(data, ignore_errors=True)
    if errors:
        raise AssertionError(f"{what}: {len(errors)} threads died: "
                             f"{errors[:5]}")
    left = [t.name for t in threading.enumerate()
            if t.name.startswith(("client-", "alloc-", "task-", "health-",
                                  "checks-", "hoststats"))]
    if left:
        raise AssertionError(f"{what}: {len(left)} client threads outlived "
                             f"the stop: {left[:8]}")

    launched = counts["launches"]
    if device != "cpu":
        missing = [n for n in ("bulk_fill", "solve_task_group",
                               "scatter_add") if not launched.get(n)]
        if missing:
            raise AssertionError(f"{what}: {missing} never launched: "
                                 f"{launched}")
        if (len(b1) != launched["bulk_fill"]
                or len(b9) != launched["solve_task_group"]):
            raise AssertionError(f"{what}: captured B1 {len(b1)}, B9 "
                                 f"{len(b9)} of {launched}")
    if any(counts["plain_on_cuda"].values()):
        raise AssertionError(f"{what}: plain versions ran on CUDA: "
                             f"{counts['plain_on_cuda']}")
    for i, (before, args, g, used, cnt) in enumerate(b1):
        u1, c1 = solve_bulk_multi(before.clone(), *args, g=g)
        u2, c2 = solve_bulk_multi_ref(before.clone(), *args, g=g)
        if not (torch.equal(u1, u2) and torch.equal(c1, c2)
                and torch.equal(u1, used) and torch.equal(c1, cnt)):
            raise AssertionError(f"{what}: B1 launch {i} differs from its "
                                 f"plain version or the path's output")
    err = 0.0
    for i, (packed, out) in enumerate(b9):
        got = kernels.solve_task_group_fused(*packed)
        want9 = kernels.solve_task_group_fused_ref(*packed)
        if not (torch.equal(got[:2], want9[:2]) and torch.equal(got, out)):
            raise AssertionError(f"{what}: B9 launch {i} differs from its "
                                 f"plain version or the path's output")
        err = max(err, score_err(got[2], want9[2], f"{what} B9 {i}"))
    b4_rec = replay_b4(torch, b4, what)
    pct = (lambda q: float(np.percentile(syncs, q))) if syncs else (
        lambda q: None)
    rec = {"clients": n_clients, "batch": k, "service": svc_k,
           "fleet_start_s": fleet_s, "placed_s": placed_s, "wall_s": wall,
           "client_sync": {"n": len(syncs), "p50_ms": pct(50),
                           "p99_ms": pct(99)},
           "hub": hub, "batcher": synced, "peak_threads": peak[0],
           "stop_s": stop_s, "feed": feed_stats, "twin": twin,
           "replays": {"bulk_fill": len(b1), "solve_task_group": len(b9),
                       "b9_max_score_err": err, "scatter_add": b4_rec},
           "launches": {n: v for n, v in launched.items() if v},
           "card": card}
    print(f"{what:<11} [{card}] step (b): {n_clients} clients up in "
          f"{fleet_s:.3f} s; {k} batch allocs complete and {svc_k} "
          f"service allocs running, every status from the clients "
          f"through the batcher ({synced}); submit to placed "
          f"{placed_s:.3f} s, to the last complete {wall:.3f} s; client.sync p50 {pct(50)} ms p99 {pct(99)} ms "
          f"({len(syncs)}); the hub pushed {hub['deltas']} deltas in "
          f"{hub['events']} events against {hub['resyncs']} full "
          f"resyncs; peak threads {peak[0]}; stop {stop_s:.3f} s")
    print(f"{what:<11} [{card}] step (b): launches {rec['launches']}; "
          f"replays exact: B1 {len(b1)}, B9 {len(b9)} (scores within "
          f"{SCORE_TOL}, max {err:.3g}), B4 {b4_rec}; the twin's "
          f"catch-ups {twin}; feed {feed_stats}")
    return launched, rec


def phase_clients(torch, card, device="cuda", agent_clients=CL_CLIENTS,
                  n_clients=CL_FLEET, k=CL_FLEET_K, svc_k=CL_FLEET_SVC_K,
                  workers=SERVER_WORKERS):
    """The client agent on the card (see the module docstring): step (a)
    through the CLI, step (b) in-process at full width. Returns step
    (b)'s launch counts and the phase's record."""
    t0 = time.perf_counter()
    agent_rec = clients_agent(torch, card, device, n_clients=agent_clients)
    launched, fleet = clients_fleet(torch, card, device, n_clients, k,
                                    svc_k, workers)
    rec = {"agent": agent_rec, "fleet": fleet,
           "phase_s": time.perf_counter() - t0}
    print(f"clients     [{card}] the phase in {rec['phase_s']:.3f} s")
    return launched, rec


def clients_only(torch, card) -> int:
    """``--clients``: the build and the clients phase alone; its record
    and the kernels' launches on step (b) as JSON lines."""
    launched, rec = phase_clients(torch, card)
    print(json.dumps({"clients": rec}))
    print(json.dumps({"kernels": [
        {"name": n, "clients_launches": launched.get(n, 0)}
        for n in ("bulk_fill", "solve_task_group", "scatter_add")]}))
    print(card)
    return 0


def columns_only(torch, card, rng) -> int:
    """``--columns``: the build, then phase_columns alone; prints its
    record and the six kernels' width records as JSON lines."""
    _, rec, widths = phase_columns(torch, card, rng=rng)
    print(json.dumps({"columns": rec}))
    print(json.dumps({"by_columns": widths}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def big_only(torch, card) -> int:
    """``--big-cluster``: the build, then phase_big_cluster alone."""
    _, rec = phase_big_cluster(torch, card)
    print(json.dumps({"big_cluster": rec}))
    print(card)
    return 0


def wide_only(torch, dev, card, rng) -> int:
    """``--wide``: the build, then phase_wide_kernels alone."""
    out = phase_wide_kernels(torch, dev, card, rng)
    print(json.dumps({"wide": out}))
    print(card)
    return 0


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
    if sys.argv[1:] == ["--lifecycle"]:
        return lifecycle_only(torch, card)
    if sys.argv[1:] == ["--autopilot"]:
        return autopilot_only(torch, card)
    if sys.argv[1:] == ["--replicated"]:
        return replicated_only(torch, card)
    if sys.argv[1:] == ["--http"]:
        return http_only(torch, card)
    if sys.argv[1:] == ["--wide"]:
        return wide_only(torch, dev, card, rng)
    if sys.argv[1:] == ["--big-cluster"]:
        return big_only(torch, card)
    if sys.argv[1:] == ["--columns"]:
        return columns_only(torch, card, rng)
    if sys.argv[1:] == ["--clients"]:
        return clients_only(torch, card)
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
    launches, server["lifecycle"], b9_lifecycle = phase_lifecycle(torch, card)
    per_eval.append(b9_lifecycle)
    bulk[2]["lifecycle_launches"] = launches["bulk_fill"]
    bulk[1]["lifecycle_launches"] = launches["scatter_add"]
    ap_launches, server["autopilot"] = phase_autopilot(torch, card)
    bulk[2]["autopilot_launches"] = ap_launches["bulk_fill"]
    bulk[1]["autopilot_launches"] = ap_launches["scatter_add"]
    per_eval[1]["autopilot_launches"] = ap_launches["solve_task_group"]
    repl_launches, server["replicated"] = phase_replicated(
        torch, card, server_rec=arms["1"][1])
    bulk[2]["replicated_launches"] = repl_launches["bulk_fill"]
    bulk[1]["replicated_launches"] = repl_launches["scatter_add"]
    http_launches, server["http"] = phase_http(torch, card)
    launches, wall, captured = phase_solve_path(torch, card)
    joint = phase_solve_launches(torch, card, wall, captured)
    for k in joint:
        k["launches"] = launches[k["name"]]
        k["http_launches"] = http_launches[k["name"]]
    bulk[2]["http_launches"] = http_launches["bulk_fill"]
    bulk[1]["http_launches"] = http_launches["scatter_add"]
    per_eval[1]["http_launches"] = http_launches["solve_task_group"]
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
    large[0]["autopilot_launches"] = ap_launches["bulk_scan"]
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
    wide = phase_wide_kernels(torch, dev, card, rng)
    big_launches, server["big_cluster"] = phase_big_cluster(torch, card)
    col_launches, server["columns"], by_columns = phase_columns(torch, card,
                                                                rng=rng)
    per_eval[1]["columns_launches"] = col_launches["solve_task_group"]
    cl_launches, server["clients"] = phase_clients(torch, card)
    bulk[2]["clients_launches"] = cl_launches["bulk_fill"]
    bulk[1]["clients_launches"] = cl_launches["scatter_add"]
    per_eval[1]["clients_launches"] = cl_launches["solve_task_group"]

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    kernels = bulk + per_eval + joint + preempt + large + sharded
    for k in kernels:
        k["route"] = "cuda"
        if k["name"] in wide:
            k["wide"] = wide[k["name"]]
        if k["name"] in big_launches:
            k["big_cluster_launches"] = big_launches[k["name"]]
        if k["name"] in by_columns:
            k["by_columns"] = by_columns[k["name"]]
    extra = ("device_ms", "library_device_ms", "without_clamp",
             "ms_per_step", "setup_ms", "by_n", "server_launches", "twin",
             "by_d", "constraints_launches", "lifecycle_launches",
             "autopilot_launches", "replicated_launches",
             "penalty_launches", "http_launches", "wide",
             "big_cluster_launches", "columns_launches", "by_columns",
             "clients_launches")
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
