// B7 (nt_preempt_solve) and B12 (nt_preempt_pick): the batched preemption
// solve of K requests of one task group.
//
// Replaces: preempt_solve (nomad_tpu/tensor/kernels.py:823-910) and
// preempt_pick (kernels.py:766-820), with the fit and preemption scores of
// fit.cuh.
//
// What nt_preempt_solve computes, K steps in order over one carry
// (used = used0, ev = sum_v v_vec * v_elig, taken = 0):
//   deficit = max(used + ask - avail, 0)                  per (node, dim)
//   can     = feasible & all(deficit <= ev)
//   score   = (fit(avail, min(used + ask, avail)) + needs * pscore)
//             / (1 + needs),  needs = any(deficit > 0), NEG where !can
//   best    = the first node of maximal score;  found = score > NEG & active
//   victims = the unclaimed eligible columns of best whose cumulative
//             vector before them is below the deficit in some dim with a
//             deficit (a priority-ascending prefix: the columns are sorted)
//   used[best] = max(used + ask - evicted, 0); ev[best] = max(ev - evicted,
//   0); taken[best] |= victims          (only when found)
// and writes picks (-1 when not found), the victim mask, whether a victim
// is flagged (holds ports or devices), and the winning score (NEG).
// nt_preempt_pick is the same node choice with the carry (used, evictable):
// used[best] = min(used + ask, avail), evictable[best] = max(evictable -
// deficit, 0); it writes picks only.
//
// Bound on the H100: neither bytes nor operations. At BASELINE config 4
// (N_pad 1,024, K_pad 512, V_pad 512, D 4) the function needs ~0.87 MB
// (v_elig, v_vec at the ~2.6k eligible columns, the outputs) and, since
// only the chosen node's carry changes in a step, about one rescore a
// step. This kernel reads v_elig whole and rescores every node on each
// of the K steps, which run one after another because each reads the
// carry the previous one wrote, so the time is K block-wide argmaxes and
// prefix scans on one SM.
//
// Design: one CTA of 1,024 threads runs all K steps, so the chain needs only
// __syncthreads. The carry (used, ev, the preemption score per node and the
// taken bits) lives in global scratch that the wrapper allocates, so any
// N_pad fits; only this CTA touches it. Each step: every thread scores its
// nodes, a block argmax by (score desc, index asc) picks the node as
// jnp.argmax does (the first maximum: on identical nodes the tie rule alone
// decides), then one thread per victim column forms the exclusive prefix
// sums of the chosen node's unclaimed eligible vectors by warp shuffles
// (1,024 columns a pass), and the chosen node's carry row is written.
//
// Exactness: resource values are integral f32 below 2^24, so every sum over
// victims (ev, the prefix sums, evicted) is exact in any order; the scores
// use correctly rounded arithmetic and accurate powf / expf (fit.cuh, built
// with --fmad=false). Picks, victims, flags and scores equal the plain torch
// version (tensor/kernels.py preempt_solve_ref / preempt_pick_ref) exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;
constexpr float kNeg = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

using nt_fit::fit_score;
using nt_fit::preempt_score;

// One node's preemption score for the next placement, and its deficit.
__device__ __forceinline__ float node_score(const float* avail,
                                            const float* used,
                                            const float* ask, const float* ev,
                                            bool feasible, float pscore, int d,
                                            float* deficit, bool* needs_out) {
  float clamped[kMaxDims];
  bool can = feasible;
  bool needs = false;
  for (int k = 0; k < d; ++k) {
    const float nu = __fadd_rn(used[k], ask[k]);
    deficit[k] = fmaxf(__fsub_rn(nu, avail[k]), 0.0f);
    can = can && deficit[k] <= ev[k];
    needs = needs || deficit[k] > 0.0f;
    clamped[k] = fminf(nu, avail[k]);
  }
  *needs_out = needs;
  const float score = __fdiv_rn(
      __fadd_rn(fit_score(avail, clamped), needs ? pscore : 0.0f),
      needs ? 2.0f : 1.0f);
  return can ? score : kNeg;
}

__device__ __forceinline__ bool better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// Block argmax by (score desc, index asc); every thread gets the result.
__device__ void block_argmax(float s, int i, float* sh_s, int* sh_i,
                             float* out_s, int* out_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(kFull, s, off);
    const int oi = __shfl_down_sync(kFull, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
  if (lane == 0) {
    sh_s[warp] = s;
    sh_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    s = sh_s[lane];
    i = sh_i[lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(kFull, s, off);
      const int oi = __shfl_down_sync(kFull, i, off);
      if (better(os, oi, s, i)) {
        s = os;
        i = oi;
      }
    }
    if (lane == 0) {
      sh_s[kWarps] = s;
      sh_i[kWarps] = i;
    }
  }
  __syncthreads();
  *out_s = sh_s[kWarps];
  *out_i = sh_i[kWarps];
}

// Block-wide exclusive prefix sums of x[0..d) (integral values: exact in any
// order); tot gets the block totals. Ends with a barrier.
__device__ void block_exclusive_scan(float (&x)[kMaxDims], int d, float* wsum,
                                     float (&tot)[kMaxDims]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float own[kMaxDims];
  for (int k = 0; k < d; ++k) {
    own[k] = x[k];
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, x[k], off);
      if (lane >= off) x[k] = __fadd_rn(x[k], y);
    }
  }
  if (lane == 31) {
    for (int k = 0; k < d; ++k) wsum[warp * kMaxDims + k] = x[k];
  }
  __syncthreads();
  for (int k = 0; k < d; ++k) {
    float before = 0.0f;
    float all = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float t = wsum[w * kMaxDims + k];
      if (w < warp) before = __fadd_rn(before, t);
      all = __fadd_rn(all, t);
    }
    x[k] = __fadd_rn(before, __fsub_rn(x[k], own[k]));
    tot[k] = all;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
preempt_solve_kernel(const float* __restrict__ avail,
                     const float* __restrict__ used0,
                     const float* __restrict__ ask,
                     const uint8_t* __restrict__ feasible,
                     const float* __restrict__ net_prio,
                     const uint8_t* __restrict__ active,
                     const float* __restrict__ v_vec,
                     const uint8_t* __restrict__ v_elig,
                     const uint8_t* __restrict__ v_flag,
                     float* scratch, uint8_t* taken, int* __restrict__ picks,
                     uint8_t* __restrict__ victims,
                     uint8_t* __restrict__ flagged,
                     float* __restrict__ scores, int n, int v, int k_steps,
                     int d) {
  __shared__ float sh_s[kWarps + 1];
  __shared__ int sh_i[kWarps + 1];
  __shared__ float wsum[kWarps * kMaxDims];
  float* used = scratch;                     // (N, D) carry
  float* ev = scratch + (long long)n * d;    // (N, D) evictable carry
  float* pscore = ev + (long long)n * d;     // (N,)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (long long j = threadIdx.x; j < (long long)n * d; j += kThreads) {
    used[j] = used0[j];
  }
  for (long long j = threadIdx.x; j < (long long)n * v; j += kThreads) {
    taken[j] = 0;
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    pscore[i] = preempt_score(net_prio[i]);
  }
  // ev0 = sum_v v_vec * v_elig: one warp per node, lanes over its columns
  for (int i = warp; i < n; i += kWarps) {
    float acc[kMaxDims];
    for (int k = 0; k < d; ++k) acc[k] = 0.0f;
    for (int c = lane; c < v; c += 32) {
      if (v_elig[(long long)i * v + c]) {
        const float* vec = v_vec + ((long long)i * v + c) * d;
        for (int k = 0; k < d; ++k) acc[k] = __fadd_rn(acc[k], vec[k]);
      }
    }
    for (int k = 0; k < d; ++k) {
      for (int off = 16; off > 0; off >>= 1) {
        acc[k] = __fadd_rn(acc[k], __shfl_down_sync(kFull, acc[k], off));
      }
      if (lane == 0) ev[(long long)i * d + k] = acc[k];
    }
  }
  __syncthreads();

  float def[kMaxDims];
  for (int step = 0; step < k_steps; ++step) {
    float best_s = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      bool needs;
      const float s = node_score(avail + (long long)i * d,
                                 used + (long long)i * d, ask,
                                 ev + (long long)i * d, feasible[i] != 0,
                                 pscore[i], d, def, &needs);
      if (better(s, i, best_s, best_i)) {
        best_s = s;
        best_i = i;
      }
    }
    block_argmax(best_s, best_i, sh_s, sh_i, &best_s, &best_i);
    const bool found = best_s > kNeg && active[step] != 0;
    uint8_t* vrow = victims + (long long)step * v;
    if (!found) {
      for (int c = threadIdx.x; c < v; c += kThreads) vrow[c] = 0;
      if (threadIdx.x == 0) {
        picks[step] = -1;
        flagged[step] = 0;
        scores[step] = kNeg;
      }
      continue;  // no carry write: the next step's argmax barriers suffice
    }
    const int b = best_i;
    bool needs;
    node_score(avail + (long long)b * d, used + (long long)b * d, ask,
               ev + (long long)b * d, true, 0.0f, d, def, &needs);
    float evicted[kMaxDims];
    for (int k = 0; k < d; ++k) evicted[k] = 0.0f;
    bool any_flag = false;
    if (needs) {
      float carry[kMaxDims];
      for (int k = 0; k < d; ++k) carry[k] = 0.0f;
      for (int base = 0; base < v; base += kThreads) {
        const int c = base + threadIdx.x;
        const long long col = (long long)b * v + c;
        const bool row = c < v && v_elig[col] && !taken[col];
        float x[kMaxDims];
        float tot[kMaxDims];
        for (int k = 0; k < d; ++k) {
          x[k] = row ? v_vec[col * d + k] : 0.0f;
        }
        block_exclusive_scan(x, d, wsum, tot);
        bool sel = false;
        for (int k = 0; k < d; ++k) {
          sel = sel || (def[k] > 0.0f && __fadd_rn(carry[k], x[k]) < def[k]);
          carry[k] = __fadd_rn(carry[k], tot[k]);
        }
        sel = sel && row;
        if (c < v) {
          vrow[c] = sel;
          if (sel) {
            taken[col] = 1;
            any_flag = any_flag || v_flag[col] != 0;
            const float* vec = v_vec + col * d;
            for (int k = 0; k < d; ++k) {
              evicted[k] = __fadd_rn(evicted[k], vec[k]);
            }
          }
        }
      }
      // evicted: block sum of the selected vectors (exact, integral)
      float tot[kMaxDims];
      block_exclusive_scan(evicted, d, wsum, tot);
      for (int k = 0; k < d; ++k) evicted[k] = tot[k];
    } else {
      for (int c = threadIdx.x; c < v; c += kThreads) vrow[c] = 0;
    }
    const bool flag = __syncthreads_or(any_flag);
    if (threadIdx.x == 0) {
      picks[step] = b;
      flagged[step] = flag;
      scores[step] = best_s;
      float* u = used + (long long)b * d;
      float* e = ev + (long long)b * d;
      for (int k = 0; k < d; ++k) {
        u[k] = fmaxf(__fsub_rn(__fadd_rn(u[k], ask[k]), evicted[k]), 0.0f);
        e[k] = fmaxf(__fsub_rn(e[k], evicted[k]), 0.0f);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
preempt_pick_kernel(const float* __restrict__ avail,
                    const float* __restrict__ used0,
                    const float* __restrict__ evictable0,
                    const float* __restrict__ ask,
                    const uint8_t* __restrict__ feasible,
                    const float* __restrict__ net_prio,
                    const uint8_t* __restrict__ active, float* scratch,
                    int* __restrict__ picks, int n, int k_steps, int d) {
  __shared__ float sh_s[kWarps + 1];
  __shared__ int sh_i[kWarps + 1];
  float* used = scratch;                     // (N, D) carry
  float* ev = scratch + (long long)n * d;    // (N, D) evictable carry
  float* pscore = ev + (long long)n * d;     // (N,)
  for (long long j = threadIdx.x; j < (long long)n * d; j += kThreads) {
    used[j] = used0[j];
    ev[j] = evictable0[j];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) {
    pscore[i] = preempt_score(net_prio[i]);
  }
  __syncthreads();

  float def[kMaxDims];
  for (int step = 0; step < k_steps; ++step) {
    float best_s = -INFINITY;
    int best_i = 0x7fffffff;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      bool needs;
      const float s = node_score(avail + (long long)i * d,
                                 used + (long long)i * d, ask,
                                 ev + (long long)i * d, feasible[i] != 0,
                                 pscore[i], d, def, &needs);
      if (better(s, i, best_s, best_i)) {
        best_s = s;
        best_i = i;
      }
    }
    block_argmax(best_s, best_i, sh_s, sh_i, &best_s, &best_i);
    const bool found = best_s > kNeg && active[step] != 0;
    if (threadIdx.x == 0) {
      picks[step] = found ? best_i : -1;
      if (found) {
        const int b = best_i;
        const float* a = avail + (long long)b * d;
        float* u = used + (long long)b * d;
        float* e = ev + (long long)b * d;
        bool needs;
        node_score(a, u, ask, e, true, 0.0f, d, def, &needs);
        for (int k = 0; k < d; ++k) {
          u[k] = fminf(__fadd_rn(u[k], ask[k]), a[k]);
          e[k] = fmaxf(__fsub_rn(e[k], def[k]), 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int nt_preempt_solve(const void* avail, const void* used0,
                                const void* ask, const void* feasible,
                                const void* net_prio, const void* active,
                                const void* v_vec, const void* v_elig,
                                const void* v_flag, void* scratch,
                                void* taken, void* picks, void* victims,
                                void* flagged, void* scores, int n, int v,
                                int k, int d, void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || v <= 0 || d < 2 || d > kMaxDims) {
    return (int)cudaErrorInvalidValue;
  }
  preempt_solve_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)used0, (const float*)ask,
      (const uint8_t*)feasible, (const float*)net_prio,
      (const uint8_t*)active, (const float*)v_vec, (const uint8_t*)v_elig,
      (const uint8_t*)v_flag, (float*)scratch, (uint8_t*)taken, (int*)picks,
      (uint8_t*)victims, (uint8_t*)flagged, (float*)scores, n, v, k, d);
  return (int)cudaGetLastError();
}

extern "C" int nt_preempt_pick(const void* avail, const void* used0,
                               const void* evictable0, const void* ask,
                               const void* feasible, const void* net_prio,
                               const void* active, void* scratch, void* picks,
                               int n, int k, int d, void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || d < 2 || d > kMaxDims) return (int)cudaErrorInvalidValue;
  preempt_pick_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)used0, (const float*)evictable0,
      (const float*)ask, (const uint8_t*)feasible, (const float*)net_prio,
      (const uint8_t*)active, (float*)scratch, (int*)picks, n, k, d);
  return (int)cudaGetLastError();
}
