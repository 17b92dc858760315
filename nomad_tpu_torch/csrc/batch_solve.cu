// B5 (nt_auction) and the pick of B6 (nt_batch_pick): the joint solve of
// SchedulerAlgorithm="tpu-solve".
//
// Replaces: _auction (nomad_tpu/tensor/batch_solver.py:137-253) with its
// five PORTFOLIO restarts, and the packing scores, restart chain and
// auction-vs-greedy pick of solve_batch (:256-358, with _packing_score_xp
// :121-126 and kernels._pairwise_sum_xp kernels.py:91-110). The rest of
// solve_batch runs as the port's other kernels on the same stream: the
// correction fold (scatter.cu), the greedy arm (jitter.cu + bulk_fill.cu)
// and the restarts' fold_in draws (jitter.cu, nt_jitter_fold).
//
// nt_auction, per restart t (one CTA of 1024 threads each, so the restarts
// run side by side on T SMs), from used = max(used0, 0), price = 0:
//   while rnd < rounds && progressed && any(remaining > 0):
//     bid[g,n] = score(g,n) + jit[t,g,n] - price[n] where feasible, fitting
//                (within avail + evict) and remaining[g] > 0, else NEG
//     each row's R=16 best bids in XLA top_k order (bid desc, -0.0 below
//     +0.0, node index asc); each node goes to its highest bid, residual
//     ties (IEEE ==) to the lowest eval
//     each winner fills its won nodes in that order from its remaining
//     demand (cap = floor(free / ask), free read before the round's update)
//     price[n] += eps[t] on nodes that were both contested and drained
// With evict, fitness is taken at min(used + ask, avail) and over-capacity
// bids add the logistic preemption score of net_prio and divide by one more.
//
// Bound on the H100: operations. Every round scores all G x N (eval, node)
// pairs (two powf each) on one SM per restart; the bytes are a few MB.
//
// Design. The bids never leave the CTA: two warps own a row, each lane
// keeps the 16 best (key, node) pairs it has seen in registers (a 64-bit
// key: an order-preserving image of the bid over the node's complement, so
// the unique key order is exactly top_k's), the warp merges its 32 lists by
// shuffles, and one thread per row merges the two warps' lists. The <= G x R
// surfaced entries live in shared memory; winners, caps, the row fill and
// the price bumps are resolved there by comparing the entries pairwise (no
// per-node scratch, no atomics), and the only global writes of a round are
// the winners' usage, take and price cells. The loop condition is computed
// in shared memory, so the host never syncs between rounds.
//
// nt_batch_pick: one CTA scores the T restarts and the greedy arm (placed
// per node times the BestFit fitness of the final usage, summed by the
// reference's padded pairwise tree in shared memory), keeps the best
// restart by (placed, score) with the earliest winning exact ties, picks it
// against the greedy arm the same way and writes the chosen carry, the int16
// counts and the info row [auction_score, greedy_score, placed_auction,
// placed_greedy, rounds_run, auction_won].
//
// Exactness: no fast math (built with --fmad=false), __fadd_rn / __fdiv_rn
// where the reference's order matters, accurate powf and expf, so every
// output equals the plain torch version (tensor/batch_solver.py) on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"
#include "sort.cuh"
#include "topr.cuh"

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = kThreads / nt_topr::kTopR;  // one thread per surfaced entry
constexpr int kMaxPad = 16384;           // pairwise tree in shared memory
constexpr float kNeg = -1.0e30f;
// B2 and the preemption score: fit.cuh
using nt_fit::fit_score;
using nt_fit::preempt_score;
// top_k's order and the per-lane / per-warp top-R lists: topr.cuh
using nt_topr::bid_key;
using nt_topr::key_idx;
using nt_topr::key_val;
using nt_topr::kTopR;
using nt_topr::topr_insert;
using nt_topr::warp_topr;
// the reference's fixed pairwise tree: sort.cuh
using nt_sort::block_pairwise_sum;

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ used0,
               const float* __restrict__ avail,
               const uint8_t* __restrict__ feas,
               const float* __restrict__ aff, const float* __restrict__ ask,
               const int* __restrict__ kk, const float* __restrict__ jits,
               const float* __restrict__ price_eps,
               const float* __restrict__ evict,
               const float* __restrict__ net_prio, float* used_out,
               int* take_out, int* rounds_out, float* price_buf, int g,
               int n, int rounds) {
  __shared__ uint64_t cand[kMaxG][2][kTopR];
  __shared__ uint64_t ent_key[kMaxG * kTopR];
  __shared__ float ent_cap[kMaxG * kTopR];
  __shared__ int ent_amt[kMaxG * kTopR];
  __shared__ int ent_bids[kMaxG * kTopR];
  __shared__ float s_ask[kMaxG][kDims];
  __shared__ int s_rem[kMaxG];
  __shared__ int s_go;
  __shared__ int s_progress;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  float* used = used_out + (long long)t * n * kDims;
  int* take = take_out + (long long)t * g * n;
  float* price = price_buf + (long long)t * n;
  const float* jit = jits + (long long)t * g * n;
  const float eps = price_eps[t];
  const bool has_evict = evict != nullptr;
  const int n_ent = g * kTopR;

  for (int i = tid; i < n * kDims; i += kThreads) {
    used[i] = fmaxf(used0[i], 0.0f);
  }
  for (int i = tid; i < n; i += kThreads) price[i] = 0.0f;
  for (long long i = tid; i < (long long)g * n; i += kThreads) take[i] = 0;
  if (tid < g) {
    s_rem[tid] = kk[tid];
#pragma unroll
    for (int d = 0; d < kDims; ++d) s_ask[tid][d] = ask[tid * kDims + d];
  }
  __syncthreads();

  int rnd = 0;
  int progressed = 1;
  for (;;) {
    if (tid == 0) {
      int any = 0;
      for (int i = 0; i < g; ++i) any |= s_rem[i] > 0;
      s_go = rnd < rounds && progressed && any;
      s_progress = 0;
    }
    __syncthreads();
    if (!s_go) break;

    // 1. bids and each row's top R, two warps a row
    for (int row = warp >> 1; row < g; row += kWarps / 2) {
      uint64_t lst[kTopR];
#pragma unroll
      for (int i = 0; i < kTopR; ++i) lst[i] = 0;
      if (s_rem[row] > 0) {
        float a_g[kDims];
#pragma unroll
        for (int d = 0; d < kDims; ++d) a_g[d] = s_ask[row][d];
        const uint8_t* feas_g = feas + (long long)row * n;
        const float* aff_g = aff + (long long)row * n;
        const float* jit_g = jit + (long long)row * n;
        for (int i = (warp & 1) * 32 + lane; i < n; i += 64) {
          if (!feas_g[i]) continue;
          float av[kDims], nu[kDims];
          bool ok = true;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            av[d] = avail[i * kDims + d];
            const float cap_d =
                has_evict ? __fadd_rn(av[d], evict[i * kDims + d]) : av[d];
            nu[d] = __fadd_rn(used[i * kDims + d], a_g[d]);
            ok = ok && (nu[d] <= cap_d);
          }
          if (!ok) continue;
          const float af = aff_g[i];
          const bool aff_present = af != 0.0f;
          const float aff_term = aff_present ? af : 0.0f;
          const float divisor = aff_present ? 2.0f : 1.0f;
          float score;
          if (!has_evict) {
            score = __fdiv_rn(__fadd_rn(fit_score(av, nu), aff_term),
                              divisor);
          } else {
            float cl[kDims];
            bool over = false;
#pragma unroll
            for (int d = 0; d < kDims; ++d) {
              cl[d] = fminf(nu[d], av[d]);
              over = over || (nu[d] > av[d]);
            }
            const float num =
                __fadd_rn(__fadd_rn(fit_score(av, cl), aff_term),
                          over ? preempt_score(net_prio[i]) : 0.0f);
            score = __fdiv_rn(num, __fadd_rn(divisor, over ? 1.0f : 0.0f));
          }
          const float bid = __fsub_rn(__fadd_rn(score, jit_g[i]), price[i]);
          topr_insert(lst, bid_key(bid, i));
        }
      }
      warp_topr(lst, cand[row][warp & 1]);
    }
    __syncthreads();

    // 2. merge the two halves of each row
    if (tid < g) {
      const uint64_t* a = cand[tid][0];
      const uint64_t* b = cand[tid][1];
      int ia = 0, ib = 0;
      for (int j = 0; j < kTopR; ++j) {
        const uint64_t x = a[ia];
        const uint64_t y = b[ib];
        if (x >= y) {
          ent_key[tid * kTopR + j] = x;
          ++ia;
        } else {
          ent_key[tid * kTopR + j] = y;
          ++ib;
        }
      }
    }
    __syncthreads();

    // 3. winners (best bid on the node, ties to the lowest eval), bids per
    //    node and each won node's capacity, against usage before the round
    if (tid < n_ent) {
      const uint64_t key = ent_key[tid];
      int bids = 0;
      float cap = 0.0f;
      if (key != 0) {
        const int idx = key_idx(key);
        const float v = key_val(key);
        const int ge = tid / kTopR;
        bool won = true;
        for (int o = 0; o < n_ent; ++o) {
          const uint64_t ko = ent_key[o];
          if (ko == 0 || key_idx(ko) != idx) continue;
          ++bids;
          const float vo = key_val(ko);
          if (vo > v || (vo == v && o / kTopR < ge)) won = false;
        }
        if (won) {
          float per = INFINITY;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            const float a_d = s_ask[ge][d];
            if (a_d > 0.0f) {
              const float av = avail[idx * kDims + d];
              const float cap_d =
                  has_evict ? __fadd_rn(av, evict[idx * kDims + d]) : av;
              const float free_d = __fsub_rn(cap_d, used[idx * kDims + d]);
              per = fminf(per, floorf(__fdiv_rn(free_d, a_d)));
            }
          }
          cap = fmaxf(per, 0.0f);
        }
      }
      ent_bids[tid] = bids;
      ent_cap[tid] = cap;
    }
    __syncthreads();

    // 4. each row spends its demand over its won nodes in score order:
    //    amt = clip(remaining - (cumsum(cap) - cap), 0, cap), NaN -> 0
    if (tid < g) {
      const float rem_f = (float)s_rem[tid];
      float cum = 0.0f;
      int total = 0;
      for (int j = 0; j < kTopR; ++j) {
        const int e = tid * kTopR + j;
        const float c = ent_cap[e];
        cum = __fadd_rn(cum, c);
        const float x = __fsub_rn(rem_f, __fsub_rn(cum, c));
        const int amt = (int)fminf(fmaxf(x, 0.0f), c);
        ent_amt[e] = amt;
        total += amt;
      }
      s_rem[tid] -= total;
      if (total > 0) s_progress = 1;
    }
    __syncthreads();

    // 5. the round's usage, take and price updates (one winner per node)
    if (tid < n_ent) {
      const uint64_t key = ent_key[tid];
      const int amt = ent_amt[tid];
      if (key != 0) {
        const int idx = key_idx(key);
        const int row = tid / kTopR;
        if (amt > 0) {
          const float af = (float)amt;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            used[idx * kDims + d] = __fadd_rn(
                used[idx * kDims + d], __fmul_rn(s_ask[row][d], af));
          }
          take[(long long)row * n + idx] += amt;
        }
        const float cap = ent_cap[tid];
        if (cap > 0.0f && (float)amt >= cap && ent_bids[tid] > 1) {
          price[idx] = __fadd_rn(price[idx], eps);
        }
      }
    }
    __syncthreads();
    ++rnd;
    progressed = s_progress;
  }
  if (tid == 0) rounds_out[t] = rnd;
}

// one arm's packing score into *score and its placed total into *placed:
// arm < n_restarts is restart arm, arm == n_restarts the greedy arm
__device__ void packing_score(float* tree, int* s_placed,
                              const float* __restrict__ avail,
                              const float* __restrict__ used_t,
                              const int* __restrict__ take_t,
                              const float* __restrict__ used_g,
                              const int16_t* __restrict__ counts_g, int arm,
                              int n_restarts, int g, int n, int p,
                              float* score, int* placed) {
  const int tid = threadIdx.x;
  if (tid == 0) *s_placed = 0;
  __syncthreads();
  const bool greedy = arm == n_restarts;
  const float* used = greedy ? used_g : used_t + (long long)arm * n * kDims;
  const int* take = take_t + (long long)arm * g * n;
  int local = 0;
  for (int i = tid; i < p; i += kThreads) {
    float v = 0.0f;
    if (i < n) {
      int c = 0;
      for (int row = 0; row < g; ++row) {
        c += greedy ? (int)counts_g[(long long)row * n + i]
                    : take[(long long)row * n + i];
      }
      v = __fmul_rn((float)c, fit_score(avail + i * kDims, used + i * kDims));
      local += c;
    }
    tree[i] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_xor_sync(0xffffffffu, local, off);
  }
  if ((tid & 31) == 0) atomicAdd(s_placed, local);
  __syncthreads();
  // v[i] = v[2i] + v[2i+1] until one is left (kernels._pairwise_sum_xp)
  const float total =
      block_pairwise_sum<kThreads, kMaxPad / 2 / kThreads>(tree, p);
  *score = total;
  *placed = *s_placed;
  __syncthreads();  // tree and s_placed are reused by the next arm
}

__global__ void __launch_bounds__(kThreads)
batch_pick_kernel(const float* __restrict__ avail,
                  const float* __restrict__ used_t,
                  const int* __restrict__ take_t,
                  const int* __restrict__ rounds_t,
                  const float* __restrict__ used_g,
                  const int16_t* __restrict__ counts_g, float* used_out,
                  int16_t* counts_out, float* info, int n_restarts, int g,
                  int n, int p) {
  extern __shared__ float tree[];
  __shared__ int s_placed;
  int best_t = 0;
  float best_score = 0.0f;
  int best_placed = 0;
  for (int t = 0; t < n_restarts; ++t) {
    float score;
    int placed;
    packing_score(tree, &s_placed, avail, used_t, take_t, used_g, counts_g,
                  t, n_restarts, g, n, p, &score, &placed);
    if (t == 0 || placed > best_placed ||
        (placed == best_placed && score > best_score)) {
      best_t = t;
      best_score = score;
      best_placed = placed;
    }
  }
  float score_g;
  int placed_g;
  packing_score(tree, &s_placed, avail, used_t, take_t, used_g, counts_g,
                n_restarts, n_restarts, g, n, p, &score_g, &placed_g);
  const bool pick_a = best_placed > placed_g ||
                      (best_placed == placed_g && best_score > score_g);

  const float* used_src =
      pick_a ? used_t + (long long)best_t * n * kDims : used_g;
  for (int i = threadIdx.x; i < n * kDims; i += kThreads) {
    used_out[i] = used_src[i];
  }
  const int* take = take_t + (long long)best_t * g * n;
  for (long long i = threadIdx.x; i < (long long)g * n; i += kThreads) {
    counts_out[i] = pick_a ? (int16_t)take[i] : counts_g[i];
  }
  if (threadIdx.x == 0) {
    info[0] = best_score;
    info[1] = score_g;
    info[2] = (float)best_placed;
    info[3] = (float)placed_g;
    info[4] = (float)rounds_t[best_t];
    info[5] = pick_a ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int nt_auction(const void* used0, const void* avail,
                          const void* feas, const void* aff, const void* ask,
                          const void* k, const void* jits,
                          const void* price_eps, const void* evict,
                          const void* net_prio, void* used_out,
                          void* take_out, void* rounds_out, void* price_buf,
                          int n_restarts, int g, int n, int rounds,
                          void* stream) {
  if (n_restarts <= 0) return 0;
  if (g < 1 || g > kMaxG || n < 1) return (int)cudaErrorInvalidValue;
  auction_kernel<<<n_restarts, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)used0, (const float*)avail, (const uint8_t*)feas,
      (const float*)aff, (const float*)ask, (const int*)k,
      (const float*)jits, (const float*)price_eps, (const float*)evict,
      (const float*)net_prio, (float*)used_out, (int*)take_out,
      (int*)rounds_out, (float*)price_buf, g, n, rounds);
  return (int)cudaGetLastError();
}

extern "C" int nt_batch_pick(const void* avail, const void* used_t,
                             const void* take_t, const void* rounds_t,
                             const void* used_g, const void* counts_g,
                             void* used_out, void* counts_out, void* info,
                             int n_restarts, int g, int n, void* stream) {
  if (n_restarts < 1 || g < 1 || n < 1) return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < n) p <<= 1;
  if (p > kMaxPad) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      batch_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  batch_pick_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)used_t, (const int*)take_t,
      (const int*)rounds_t, (const float*)used_g, (const int16_t*)counts_g,
      (float*)used_out, (int16_t*)counts_out, (float*)info, n_restarts, g, n,
      p);
  return (int)cudaGetLastError();
}
