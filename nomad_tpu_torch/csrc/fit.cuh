// B2, the fit arithmetic shared by bulk_fill.cu, batch_solve.cu,
// preempt.cu and, through score.cuh, task_group.cu and bulk_scan.cu.
//
// Replaces: _free_fractions_xp / _fit_scores_xp (nomad_tpu/tensor/
// kernels.py:40-79) and the logistic preemption score (kernels.py:793,
// batch_solver.py's evict arm, rank.py preemption_score).
//
// Correctly rounded division and accurate powf / expf, no contraction
// (the libraries are built with --fmad=false): each value equals the plain
// torch version's on the card.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nt_fit {

constexpr float kMaxFit = 18.0f;  // reference scheduler/rank.go:18

// free = 1 - used/avail per dim (funcs.go:213), -inf free when
// avail == 0 < used, 0 when both are 0
__device__ __forceinline__ float free_fraction(float avail, float used) {
  float ratio;
  if (avail > 0.0f) {
    ratio = __fdiv_rn(used, avail);
  } else {
    ratio = used > 0.0f ? INFINITY : 0.0f;
  }
  return __fsub_rn(1.0f, ratio);
}

// BestFit-v3 (funcs.go:236 ScoreFitBinPack) over the cpu and memory dims,
// clip(20 - (10^free0 + 10^free1), 0, 18) / 18, or with spread_alg
// WorstFit (funcs.go:263 ScoreFitSpread), clip(total - 2, 0, 18) / 18
__device__ __forceinline__ float fit_score_alg(float a0, float a1, float u0,
                                               float u1, bool spread_alg) {
  const float total = __fadd_rn(powf(10.0f, free_fraction(a0, u0)),
                                powf(10.0f, free_fraction(a1, u1)));
  const float binpack = fminf(fmaxf(__fsub_rn(20.0f, total), 0.0f), kMaxFit);
  const float spread = fminf(fmaxf(__fsub_rn(total, 2.0f), 0.0f), kMaxFit);
  return __fdiv_rn(spread_alg ? spread : binpack, kMaxFit);
}

// BestFit from (N, D) rows
__device__ __forceinline__ float fit_score(const float* avail,
                                           const float* used) {
  return fit_score_alg(avail[0], avail[1], used[0], used[1], false);
}

// 1 / (1 + exp(0.0048 * (net_prio - 2048))), the preemption score
// (rank.go:894)
__device__ __forceinline__ float preempt_score(float net_prio) {
  const float e = expf(__fmul_rn(0.0048f, __fsub_rn(net_prio, 2048.0f)));
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
}

}  // namespace nt_fit
