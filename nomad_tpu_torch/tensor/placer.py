"""TorchPlacer: the bulk placement backend behind
SchedulerAlgorithm="tpu-binpack" (reference ``nomad_tpu/tensor/placer.py``
``TPUPlacer``: the bulk branch of ``place()`` :229-330, ``_bulk_shape_ok``
and the service branch of ``_solve_bulk_counts`` :538-635,
``_place_bulk_columnar`` :637-689, ``_bulk_trajectory_mean`` :950-975).

Per eval: one ClusterTensors build; per task group, one solver-service
solve whose per-node counts become ONE AllocBlock on the plan. A group
outside the bulk shape (spread, distinct_hosts, reserved or dynamic
ports, device or core asks, distinct_property), a count above the int16
ceiling, or a remainder that would need preemption raises
``NotImplementedError`` naming the ROADMAP item that ports it; nothing
falls back to another algorithm.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..device import DeviceLike, resolve
from ..structs import enums
from .cluster import ClusterTensors, build_task_group_tensors
from .kernels import fit_scores_np
from .solver import BulkSolverService, get_service


class TorchPlacer:
    """Placer implementation: the bulk count solve on ``device``."""

    def __init__(self, algorithm: str = enums.SCHED_ALG_BINPACK,
                 device: DeviceLike = None):
        # fit formula of the solve; "tpu-binpack" keeps BestFit
        self.algorithm = algorithm
        self.device = resolve(device)

    def place(self, ctx, job, requests, nodes, commit_block, fail_bulk, *,
              preemption_enabled: bool = False, attempt: int = 0) -> None:
        """Place each BulkPlacementRequest (one per task group) and
        commit it through ``commit_block`` / ``fail_bulk``."""
        if not nodes:
            for req in requests:
                ctx.new_metrics().nodes_in_pool = 0
                fail_bulk(req.task_group, req.count)
            return
        cluster = ClusterTensors.build(ctx, nodes)
        # crc32, not hash(): the seed must be the same in every process
        # (a replayed eval explores the same tie-breaks)
        seed = zlib.crc32(f"{ctx.eval_id}:{attempt}".encode())
        for gi, bulk in enumerate(requests):
            tg = bulk.task_group
            if gi > 0:  # build() already computed usage for the first group
                cluster.refresh_usage(ctx)
            tgt = build_task_group_tensors(ctx, job, tg, cluster,
                                           algorithm=self.algorithm)
            if not self._bulk_shape_ok(ctx, tg, tgt):
                raise NotImplementedError(
                    f"task group {tg.name!r} is outside the bulk shape "
                    f"(spread algorithm, distinct_hosts or ports): ROADMAP "
                    f"queue A, slice 4 (the per-eval general path)")
            self._place_bulk_columnar(ctx, tg, bulk, cluster, tgt,
                                      commit_block, fail_bulk, seed,
                                      preemption_enabled=preemption_enabled)

    def _bulk_shape_ok(self, ctx, tg, tgt) -> bool:
        """Task-group-level bulk eligibility."""
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
                "A, slice 5 (bulk fallbacks, B11)")
        if k > BulkSolverService.MAX_K:
            raise NotImplementedError(
                f"k={k} > {BulkSolverService.MAX_K} placements in one "
                f"solve: ROADMAP queue A, slice 5 (bulk fallbacks, B11)")
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

    def _place_bulk_columnar(self, ctx, tg, bulk, cluster, tgt,
                             commit_block, fail_bulk, seed, *,
                             preemption_enabled: bool) -> None:
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
        commit_block(tg, [nodes[int(ni)].id for ni in nz],
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
                f"queue A, slice 3 (preemption, B7)")
        n_feasible = int(tgt.feasible[: len(nodes)].sum())
        self._attribute_failure(metrics, len(nodes), n_feasible)
        fail_bulk(tg, n_unplaced)

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
