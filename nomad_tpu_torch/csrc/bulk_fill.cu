// B1 (with B2 inside): the chained greedy bulk fill of G evals over one
// usage carry.
//
// Replaces: _solve_bulk_multi_impl / solve_bulk_multi after its correction
// fold and jitter draw (nomad_tpu/tensor/kernels.py:712-756), with the fit
// formula _free_fractions_xp / _fit_scores_xp (kernels.py:40-79) as the
// __device__ function fit_score of fit.cuh. The fold is the scatter kernel
// (scatter.cu) and the jitter is jitter.cu; both run before this launch on
// the same stream.
//
// What it computes, per eval g in order (the carry is updated in place):
//   used    = max(used, 0)                      (once, before eval 0)
//   ok      = feas[g] & all(used + ask[g] <= avail)
//   score   = (fit(avail, used + ask) + aff) / (1 + [aff != 0]), NEG if !ok
//   cap     = min(k, max(0, min_{ask_d > 0} floor((avail - used) / ask_d))),
//             0 where score == NEG
//   order   = nodes by (score + jitter) descending, node index ascending
//   take    = clip(k - exclusive_cumsum(cap in order), 0, cap)
//   used   += ask * take;  counts[g] = take
//
// Bound on the H100: neither bytes nor operations. The bytes are ~0.5 MB
// per launch at N_pad = 16,384 and G = 16 (a fraction of a microsecond of
// HBM time); the time goes to the full sort of N_pad keys per eval, done
// by one thread block on one of the 132 SMs, and to the G evals running
// one after another because each reads the carry the previous one wrote.
//
// Design: one CTA of 1024 threads runs all G evals of the launch, so the
// carry chain needs only __syncthreads between evals. Each eval packs, per
// node, an order-preserving 32-bit image of the key (inverted for
// descending order, -0.0 folded onto +0.0 as XLA's sort comparator does),
// the node index (16 bits) and its cap (16 bits, k <= 32767) into one
// uint64. A bitonic sort of those N_pad words in dynamic shared memory
// (128 KB at N_pad = 16,384) gives the stable (key desc, index asc) order
// of the reference's argsort(-key); a block-wide exclusive scan of the caps
// in that order gives each node's take. The multi-CTA selection that skips
// the full sort is later work (ROADMAP, "make B1 fast").
//
// Arithmetic follows the reference op for op with correctly rounded f32
// division and powf (no fast math, no contraction: built with
// --fmad=false), so the counts and carry equal the plain torch version on
// the card exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"
#include "sort.cuh"

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 1024;
constexpr float kNeg = -1.0e30f;
// B2: fit.cuh
using nt_fit::fit_score;

// the packed-key sort and the block scan: sort.cuh
using nt_sort::bitonic_sort;
using nt_sort::block_exclusive_scan;
using nt_sort::desc_key;

__global__ void __launch_bounds__(kThreads)
bulk_fill_kernel(float* __restrict__ used, const float* __restrict__ avail,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ aff, const float* __restrict__ ask,
                 const int* __restrict__ kk, const float* __restrict__ jit,
                 int16_t* __restrict__ counts, int g, int n) {
  extern __shared__ uint64_t keys[];
  __shared__ int warp_tot[32];

  for (int i = threadIdx.x; i < n * kDims; i += blockDim.x) {
    used[i] = fmaxf(used[i], 0.0f);
  }
  __syncthreads();

  const int chunk = n >= kThreads ? n / kThreads : 1;
  const int lo = threadIdx.x * chunk;
  const bool owns = lo < n;

  for (int e = 0; e < g; ++e) {
    float a_g[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d) a_g[d] = ask[e * kDims + d];
    const int budget = kk[e];
    const float budget_f = (float)budget;
    const uint8_t* feas_g = feas + (long long)e * n;
    const float* aff_g = aff + (long long)e * n;
    const float* jit_g = jit + (long long)e * n;

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      float u[kDims], av[kDims], nu[kDims];
      bool ok = feas_g[i] != 0;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        u[d] = used[i * kDims + d];
        av[d] = avail[i * kDims + d];
        nu[d] = __fadd_rn(u[d], a_g[d]);
        ok = ok && (nu[d] <= av[d]);
      }
      const float fitness = fit_score(av, nu);
      const float af = aff_g[i];
      const bool aff_present = af != 0.0f;
      const float divisor = aff_present ? 2.0f : 1.0f;
      float score = __fdiv_rn(__fadd_rn(fitness, aff_present ? af : 0.0f),
                              divisor);
      if (!ok) score = kNeg;

      float per = INFINITY;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        if (a_g[d] > 0.0f) {
          const float q = floorf(__fdiv_rn(__fsub_rn(av[d], u[d]), a_g[d]));
          per = fminf(per, q);
        }
      }
      float cap_f = fmaxf(per, 0.0f);
      if (!(score > kNeg)) cap_f = 0.0f;
      const int cap = (int)fminf(cap_f, budget_f);
      const float key = __fadd_rn(score, jit_g[i]);
      keys[i] = ((uint64_t)desc_key(key) << 32) | ((uint64_t)i << 16) |
                (uint64_t)(cap & 0xFFFF);
    }
    __syncthreads();
    bitonic_sort(keys, n);

    int local = 0;
    if (owns) {
      for (int j = lo; j < lo + chunk; ++j) local += (int)(keys[j] & 0xFFFF);
    }
    int excl = block_exclusive_scan(local, warp_tot);
    if (owns) {
      for (int j = lo; j < lo + chunk; ++j) {
        const uint64_t w = keys[j];
        const int cap = (int)(w & 0xFFFF);
        const int node = (int)((w >> 16) & 0xFFFF);
        int take = budget - excl;
        take = take < 0 ? 0 : (take > cap ? cap : take);
        excl += cap;
        counts[(long long)e * n + node] = (int16_t)take;
        if (take > 0) {
          const float tf = (float)take;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            used[node * kDims + d] =
                __fadd_rn(used[node * kDims + d], __fmul_rn(a_g[d], tf));
          }
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int nt_bulk_fill(void* used, const void* avail, const void* feas,
                            const void* aff, const void* ask, const void* k,
                            const void* jit, void* counts, int g, int n,
                            void* stream) {
  if (g <= 0) return 0;
  const size_t smem = (size_t)n * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      bulk_fill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bulk_fill_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)used, (const float*)avail, (const uint8_t*)feas,
      (const float*)aff, (const float*)ask, (const int*)k, (const float*)jit,
      (int16_t*)counts, g, n);
  return (int)cudaGetLastError();
}
