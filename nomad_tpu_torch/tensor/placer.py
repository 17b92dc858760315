"""TorchPlacer: the placement backend behind
SchedulerAlgorithm="tpu-binpack" (reference ``nomad_tpu/tensor/placer.py``
``TPUPlacer``: ``place()`` :229-505, ``_bulk_shape_ok`` and the service
branch of ``_solve_bulk_counts`` :538-635, ``_place_bulk_columnar``
:637-689, ``_bulk_trajectory_mean`` :950-975, ``_host_one`` :1046-1056).

Per eval: one ClusterTensors build and one tie-break permutation; then
per task group, one of three routes:

- bulk: a columnar request whose group has the bulk shape goes to the
  solver service; its per-node counts become ONE AllocBlock;
- host: at most ``HOST_CUTOVER`` requests go to the host oracle
  (``scheduler/rank.select_best_node``), one commit each;
- per-eval kernel: everything else (spread, distinct_hosts,
  distinct_property, groups of 17-255, expanded bulk requests) packs
  into one ``solve_task_group_fused`` launch (B9) placing all of the
  group's requests, then commits per request.

Ports, device and core asks raise (ROADMAP queue A5), and so does a
placement left for preemption (queue A4); nothing falls back to another
algorithm.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..scheduler.feasible import UNPORTED_A5
from ..scheduler.rank import RankedNode, select_best_node
from ..scheduler.reconcile import BulkPlacementRequest
from ..structs import enums
from .cluster import ClusterTensors, _pad_pow2, build_task_group_tensors
from .kernels import fit_scores_np, pack_solve_args, solve_task_group_fused
from .overlay import INFLIGHT
from .solver import BulkSolverService, get_service

# One per-eval solve at a time across racing evals: the usage gather ->
# solve -> in-flight registration is one critical section, so each solve
# plans around every earlier one's overlay entries instead of filling
# the same best-fit nodes.
_PER_EVAL_SOLVE_LOCK = threading.Lock()



class TorchPlacer:
    """Placer implementation: bulk counts, per-eval scan or host oracle
    per task group, on ``device``."""

    BULK_MIN = 256     # below this the per-placement scan is fine
    HOST_CUTOVER = 16  # at or below this the host oracle places the group

    def __init__(self, algorithm: str = enums.SCHED_ALG_BINPACK,
                 device: DeviceLike = None):
        # fit formula of the solve; "tpu-binpack" keeps BestFit
        self.algorithm = algorithm
        self.device = resolve(device)

    def place(self, ctx, job, requests, nodes, commit, *, batch: bool = False,
              preemption_enabled: bool = False, attempt: int = 0) -> None:
        """Place every request and commit each through ``commit(req,
        option)``, or a bulk group through ``commit.commit_block`` /
        ``commit.fail_bulk``."""
        if not nodes:
            for req in requests:
                ctx.new_metrics().nodes_in_pool = 0
                if isinstance(req, BulkPlacementRequest):
                    commit.fail_bulk(req.task_group, req.count)
                else:
                    commit(req, None)
            return
        cluster = ClusterTensors.build(ctx, nodes)
        nodes = cluster.nodes
        # crc32, not hash(): the seed must be the same in every process
        # (a replayed eval explores the same tie-breaks)
        seed = zlib.crc32(f"{ctx.eval_id}:{attempt}".encode())
        tie_perm = np.random.default_rng(seed).permutation(
            cluster.n_pad).astype(np.int32)

        groups: Dict[str, list] = {}
        for req in requests:
            groups.setdefault(req.task_group.name, []).append(req)
        for gi, reqs in enumerate(groups.values()):
            tg = reqs[0].task_group
            if gi > 0:  # build() already computed usage for the first group
                cluster.refresh_usage(ctx)
            self._refuse_unported(ctx, tg)
            prebuilt = None
            if len(reqs) == 1 and isinstance(reqs[0], BulkPlacementRequest):
                bulk = reqs[0]
                prebuilt = build_task_group_tensors(ctx, job, tg, cluster,
                                                    algorithm=self.algorithm)
                if self._bulk_shape_ok(ctx, tg, prebuilt):
                    self._place_bulk_columnar(
                        ctx, tg, bulk, cluster, prebuilt, commit, seed,
                        preemption_enabled=preemption_enabled)
                    continue
                # spread / distinct_* need the per-placement scan
                reqs = bulk.expand()
            if len(reqs) <= self.HOST_CUTOVER:
                for req in reqs:
                    commit(req, self._host_one(ctx, job, tg, nodes, req,
                                               batch, preemption_enabled,
                                               attempt))
                continue
            tgt = (prebuilt if prebuilt is not None
                   else build_task_group_tensors(ctx, job, tg, cluster,
                                                 algorithm=self.algorithm))
            if self._bulk_eligible(ctx, tg, reqs, tgt):
                raise NotImplementedError(
                    f"{len(reqs)} per-request placements of the bulk shape: "
                    f"ROADMAP queue A6 (bulk fallbacks, B11)")
            self._place_per_eval(ctx, tg, reqs, cluster, tgt, commit,
                                 tie_perm,
                                 preemption_enabled=preemption_enabled)

    @staticmethod
    def _refuse_unported(ctx, tg) -> None:
        res = ctx.tg_resources(tg)
        if res.reserved_port_asks() or res.dynamic_port_count():
            raise NotImplementedError(
                f"task group {tg.name!r} asks for ports: {UNPORTED_A5}")
        if res.devices or res.cores:
            raise NotImplementedError(
                f"task group {tg.name!r} asks for devices or cores: "
                f"{UNPORTED_A5}")

    def _place_per_eval(self, ctx, tg, reqs, cluster, tgt, commit, tie_perm,
                        *, preemption_enabled: bool) -> None:
        """One fused launch places every request of the group; the
        results commit per request."""
        nodes = cluster.nodes
        k = len(reqs)
        k_pad = _pad_pow2(k, floor=1)
        penalty_idx = np.full(k_pad, -1, dtype=np.int32)
        active = np.zeros(k_pad, dtype=bool)
        active[:k] = True
        for i, req in enumerate(reqs):
            if req.ignore_node:
                penalty_idx[i] = cluster.node_index.get(req.ignore_node, -1)
        with _PER_EVAL_SOLVE_LOCK:
            cluster.refresh_usage(ctx)
            packed = pack_solve_args(
                cluster.available, cluster.used, tgt.placed_tg,
                tgt.placed_job, tgt.ask, tgt.feasible, tgt.affinity_boost,
                penalty_idx, active, tgt.spread_val_id, tgt.spread_val_ok,
                tgt.spread_counts, tgt.spread_desired,
                tgt.spread_has_targets, tgt.spread_weight, -1.0,
                tgt.tg_count, tgt.dh_job, tgt.dh_tg, tgt.spread_alg,
                dev_affinity=tgt.dev_affinity, dp_val_id=tgt.dp_val_id,
                dp_val_ok=tgt.dp_val_ok, dp_counts0=tgt.dp_counts,
                dp_limit=tgt.dp_limit, tie_perm=tie_perm)
            out = solve_task_group_fused(*(
                torch.from_numpy(a).to(self.device) for a in packed)
            ).cpu().numpy()
            choices = out[0].astype(np.int64)
            founds = out[1] > 0.5
            scores = out[2]
            if ctx.plan is not None and founds.any():
                vec = ctx.tg_vec(tg)
                per_node: Dict[int, int] = {}
                for i in range(k):
                    if founds[i]:
                        ni = int(choices[i])
                        per_node[ni] = per_node.get(ni, 0) + 1
                INFLIGHT.register({nodes[ni].id: vec * c
                                   for ni, c in per_node.items()}, ctx.plan)

        n_feasible = int(tgt.feasible[: len(nodes)].sum())
        for i, req in enumerate(reqs):
            metrics = ctx.new_metrics()
            metrics.nodes_in_pool = len(nodes)
            metrics.nodes_evaluated = len(nodes)
            if founds[i]:
                node = nodes[int(choices[i])]
                option = RankedNode(node=node)
                option.final_score = float(scores[i])
                option.score_meta["normalized-score"] = option.final_score
                metrics.scores[f"{node.id}.normalized-score"] = (
                    option.final_score)
                commit(req, option)
                continue
            if preemption_enabled:
                raise NotImplementedError(
                    "placements left for preemption: ROADMAP queue A4")
            self._attribute_failure(metrics, len(nodes), n_feasible)
            commit(req, None)

    def _host_one(self, ctx, job, tg, nodes, req, batch: bool,
                  preemption_enabled: bool, attempt: int):
        """The host oracle for one request of a small group."""
        penalty = (frozenset({req.ignore_node}) if req.ignore_node
                   else frozenset())
        return select_best_node(ctx, job, tg, nodes, batch=batch,
                                algorithm=self.algorithm,
                                preemption_enabled=preemption_enabled,
                                penalty_nodes=penalty, attempt=attempt)

    def _bulk_eligible(self, ctx, tg, reqs, tgt) -> bool:
        """K large, every request fresh and the group of the bulk shape:
        the count-based solve (B11) would place them."""
        if len(reqs) < self.BULK_MIN or not self._bulk_shape_ok(ctx, tg, tgt):
            return False
        return all(req.previous_alloc is None and not req.ignore_node
                   and not req.canary for req in reqs)

    def _bulk_shape_ok(self, ctx, tg, tgt) -> bool:
        """Task-group-level bulk eligibility: BestFit with no spread,
        distinct_hosts, distinct_property, extra columns or ports."""
        if tgt.spread_alg or tgt.dh_job or tgt.dh_tg:
            return False
        if tgt.spread_val_id.shape[0] or len(tgt.extra_ask):
            return False
        if tgt.dp_val_id.shape[0]:
            return False
        ask_res = ctx.tg_resources(tg)
        return not (ask_res.reserved_port_asks()
                    or ask_res.dynamic_port_count())

    def _solve_bulk_counts(self, ctx, cluster, tgt, k: int,
                           seed) -> np.ndarray:
        """(N_pad,) int64 per-node counts from the solver service."""
        static = cluster.static
        if static is None or tgt.feas_base is None:
            raise NotImplementedError(
                "bulk solve without a cached ClusterStatic: ROADMAP queue "
                "A6 (bulk fallbacks, B11)")
        if k > BulkSolverService.MAX_K:
            raise NotImplementedError(
                f"k={k} > {BulkSolverService.MAX_K} placements in one "
                f"solve: ROADMAP queue A6 (bulk fallbacks, B11)")
        service = get_service(self.device)
        counts, token = service.solve(
            static=static, feas_base=tgt.feas_base, aff=tgt.affinity_boost,
            ask=tgt.ask, k=k, tg_count=tgt.tg_count, seed=seed,
            used_fn=cluster.latest_usage)
        if ctx.plan is not None:
            ctx.plan.post_apply_hooks.append(
                lambda result, _t=token: service.confirm(
                    _t, getattr(result, "rejected_nodes", None) or ()))
        return counts

    def _place_bulk_columnar(self, ctx, tg, bulk, cluster, tgt, commit,
                             seed, *, preemption_enabled: bool) -> None:
        """The C2M commit shape: one solve -> one AllocBlock. Host work
        is O(touched nodes), not O(K)."""
        k = bulk.count
        counts = self._solve_bulk_counts(ctx, cluster, tgt, k, seed)
        mean_score = self._bulk_trajectory_mean(counts, cluster, tgt)

        metrics = ctx.new_metrics()
        metrics.nodes_in_pool = len(cluster.nodes)
        metrics.nodes_evaluated = len(cluster.nodes)
        metrics.scores["bulk.normalized-score"] = mean_score

        nz = np.nonzero(counts)[0]
        placed_counts = counts[nz]
        total = int(placed_counts.sum())
        nodes = cluster.nodes
        commit.commit_block(tg, [nodes[int(ni)].id for ni in nz],
                     [nodes[int(ni)].name for ni in nz],
                     placed_counts.astype(np.int64),
                     np.asarray(bulk.name_indices[:total], dtype=np.int64),
                     mean_score)

        n_unplaced = k - total
        if not n_unplaced:
            return
        if preemption_enabled:
            raise NotImplementedError(
                f"{n_unplaced} placements left for preemption: ROADMAP "
                f"queue A4 (preemption, B7)")
        n_feasible = int(tgt.feasible[: len(nodes)].sum())
        self._attribute_failure(metrics, len(nodes), n_feasible)
        commit.fail_bulk(tg, n_unplaced)

    @staticmethod
    def _bulk_trajectory_mean(counts: np.ndarray, cluster, tgt) -> float:
        """Exact mean normalized score over the greedy trajectory the
        bulk counts correspond to, computed on the host: fit +
        anti-affinity + node-affinity sub-scores, as the reference
        scores each placement."""
        nz = np.nonzero(counts)[0]
        if not len(nz):
            return 0.0
        c = counts[nz]
        total = int(c.sum())
        idx = np.repeat(nz, c)
        starts = np.concatenate([[0], np.cumsum(c)[:-1]])
        t = np.arange(total) - np.repeat(starts, c) + 1.0  # 1..c per node
        ask = np.asarray(tgt.ask, dtype=np.float64)
        avail = cluster.available[idx]
        used = cluster.used[idx] + t[:, None] * ask[None, :]
        fit = fit_scores_np(avail, used)
        ptg_before = tgt.placed_tg[idx] + t - 1.0
        anti_present = ptg_before > 0
        anti = -(ptg_before + 1.0) / max(tgt.tg_count, 1.0)
        aff = tgt.affinity_boost[idx]
        aff_present = aff != 0.0
        div = 1.0 + anti_present.astype(float) + aff_present.astype(float)
        score = (fit + np.where(anti_present, anti, 0.0) + aff) / div
        return float(score.mean())

    @staticmethod
    def _attribute_failure(metrics, n_nodes: int, n_feasible: int) -> None:
        """Nodes masked by constraints/drivers count as "filtered", nodes
        that passed feasibility but did not fit as "exhausted"."""
        masked = n_nodes - n_feasible
        if masked:
            metrics.nodes_filtered += masked
            metrics.constraint_filtered["task group constraints"] = (
                metrics.constraint_filtered.get("task group constraints", 0)
                + masked)
        if n_feasible > 0:
            metrics.exhaust_node("resources")
