// B13, B14 and B15: the node-sharded solve of nomad_tpu/tensor/sharding.py.
//
// Replaces:
//   B15 nt_scatter_shards  make_state_scatter_sharded (sharding.py:144-179)
//                          and the correction fold of B13/B14 (:213-220,
//                          :427-432, with their max(., 0) clamp)
//   B13 nt_bulk_shard_pool _bulk_shard_body (:198-315) under
//       nt_bulk_shard_merge make_solve_bulk_multi_sharded (:318-365)
//   B14 nt_joint_shard_bids, _joint_body of make_solve_batch_sharded
//       nt_joint_shard_merge, (:368-629): the auction rounds (:452-541),
//       nt_joint_shard_contrib, det_score (:550-561) and the restart chain
//       nt_joint_shard_pick  and pick (:563-606)
//
// Layout. Shard s of S owns the global node rows [s * n_loc, (s+1) * n_loc)
// and its own arrays on its device: (n_loc, 4) rows, (G, n_loc) columns.
// Every launch covers one shard (B14's: one CTA per restart or arm). B15
// issues its S launches from one host call (nt_scatter_shards). The
// replicated state (the reference's replicated while-loop carry) is kept
// once per shard. The all-gather runs between launches: each shard writes
// its pool into its slice of an (S, ...) buffer on its device, and the host
// copies the other shards' slices in. So the kernels are the same whether S
// shards share one card or each has its own.
//
// Loop conditions stay on the device. B13: the host queues a chunk of
// rounds for each eval; a pool or merge launch whose eval has ended (go 0)
// returns at once, and an eval still going after its chunk sets the
// shard's stall word, which makes every later launch of the chain return,
// until the host reads it (once per solve) and resumes. B14: the restarts'
// rounds run in chunks the same way, each restart with its own go flag.
//
// Bound on the H100: neither bytes nor operations, as for B1 and B5. B13's
// pool sorts the shard's n_loc keys in shared memory each round (one SM a
// shard); B14's bids rescan every (eval, node) pair of the shard each round.
// The merges are small: S x R <= 2,048 entries (B13), G x S x 16 (B14).
//
// Exactness. The per-node arithmetic is B1's and B5's (fit.cuh, correctly
// rounded division, no contraction: --fmad=false). Pools keep the
// reference's f32 triplets (key, cap, global id). The local top-R is
// jax.lax.top_k's order (value desc in the total order, -0.0 below +0.0,
// index asc); the merges are lexsort's / lax.sort's (key desc with -0.0
// equal to +0.0, global id asc). Usage adds are of integral f32 values, so
// the atomics of the fold are exact in any order. Every output equals the
// plain torch version (tensor/sharding.py) on the card.

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
constexpr float kNeg = -1.0e30f;
constexpr int kMaxMerge = 2048;    // B13: S x R entries a merge sorts
constexpr int kMaxJoint = 1024;    // B14: G x 16 surfaced entries a round
constexpr int kMaxG = 64;
constexpr int kMaxTree = 32768;    // B14: nodes the pick's tree sums

using nt_fit::fit_score;
using nt_fit::preempt_score;
using nt_sort::bitonic_sort;
using nt_sort::block_exclusive_scan;
using nt_sort::block_pairwise_sum;
using nt_sort::desc_key;
using nt_topr::bid_key;
using nt_topr::key_idx;
using nt_topr::key_val;
using nt_topr::kTopR;
using nt_topr::topr_insert;
using nt_topr::warp_topr;

// top_k's descending order as an ascending uint32: the complement of the
// float's total-order image (-0.0 below +0.0)
__device__ __forceinline__ uint32_t topk_desc(float v) {
  const uint32_t u = __float_as_uint(v);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// ---------------------------------------------------------------------------
// B15: used[idx] += delta on the shard's own rows, then (clamp) max(., 0)
// ---------------------------------------------------------------------------
//
// Without the clamp, one thread per (row, dim) over as many CTAs as the
// rows need, as B4: a twin flush of thousands of rows fills the card. With
// it (the B13/B14 correction fold), one CTA a shard: every add has landed
// (__syncthreads) before the clamp of all the shard's rows, 16 bytes a
// thread.

__global__ void scatter_shard_kernel(float* __restrict__ used,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ delta, int b,
                                     int n_loc, int s) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= b * kDims) return;
  const int row = idx[t / kDims] - s * n_loc;
  if (row < 0 || row >= n_loc) return;  // another shard's row
  atomicAdd(&used[(long long)row * kDims + t % kDims], delta[t]);
}

__global__ void scatter_clamp_shard_kernel(float* __restrict__ used,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ delta,
                                           int b, int n_loc, int s) {
  const int lo = s * n_loc;
  for (int t = threadIdx.x; t < b * kDims; t += blockDim.x) {
    const int row = idx[t / kDims] - lo;
    if (row < 0 || row >= n_loc) continue;
    atomicAdd(&used[(long long)row * kDims + t % kDims], delta[t]);
  }
  __syncthreads();
  float4* rows = reinterpret_cast<float4*>(used);
  for (int r = threadIdx.x; r < n_loc; r += blockDim.x) {
    float4 v = rows[r];
    v.x = fmaxf(v.x, 0.0f);
    v.y = fmaxf(v.y, 0.0f);
    v.z = fmaxf(v.z, 0.0f);
    v.w = fmaxf(v.w, 0.0f);
    rows[r] = v;
  }
}

// ---------------------------------------------------------------------------
// B13: the distributed greedy fill
// ---------------------------------------------------------------------------
//
// scratch (3, n_loc) int32: the shard's keys (f32 bits), caps, takes.
// state (1 + 3 G) int32: the stall word (eval + 1, or 0), then budget, go
// and rounds per eval.

__global__ void __launch_bounds__(kThreads)
bulk_pool_kernel(const float* __restrict__ used,
                 const float* __restrict__ avail,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ aff, const float* __restrict__ ask,
                 const int* __restrict__ kk, const float* __restrict__ jit,
                 int* __restrict__ scratch, int* __restrict__ state,
                 float* __restrict__ pools, int e, int g, int n_loc, int s,
                 int r, int first, int p) {
  extern __shared__ uint64_t keys[];
  const int lo = s * n_loc;
  int* st = state;
  if (st[0] != 0) return;  // the chain stalled at an earlier eval
  int* ev = st + 1 + 3 * e;  // budget, go, rounds
  float* key_loc = reinterpret_cast<float*>(scratch);
  int* cap_loc = scratch + n_loc;
  int* take_loc = scratch + 2 * n_loc;

  if (first) {
    // the eval's start (sharding.py:223-249): score, cap, key
    const int budget0 = kk[e];
    const float budget_f = (float)budget0;
    float a_g[kDims];
#pragma unroll
    for (int d = 0; d < kDims; ++d) a_g[d] = ask[e * kDims + d];
    const float* u_s = used;
    const float* av_s = avail;
    const uint8_t* feas_g = feas + (long long)e * n_loc;
    const float* aff_g = aff + (long long)e * n_loc;
    const float* jit_g = jit + (long long)e * n_loc;
    for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
      float u[kDims], av[kDims], nu[kDims];
      bool ok = feas_g[i] != 0;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        u[d] = u_s[i * kDims + d];
        av[d] = av_s[i * kDims + d];
        nu[d] = __fadd_rn(u[d], a_g[d]);
        ok = ok && (nu[d] <= av[d]);
      }
      const float af = aff_g[i];
      const bool aff_present = af != 0.0f;
      float score = __fdiv_rn(
          __fadd_rn(fit_score(av, nu), aff_present ? af : 0.0f),
          aff_present ? 2.0f : 1.0f);
      if (!ok) score = kNeg;
      float per = INFINITY;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        if (a_g[d] > 0.0f) {
          per = fminf(per,
                      floorf(__fdiv_rn(__fsub_rn(av[d], u[d]), a_g[d])));
        }
      }
      float cap_f = fmaxf(per, 0.0f);
      if (!(score > kNeg)) cap_f = 0.0f;
      key_loc[i] = __fadd_rn(score, jit_g[i]);
      cap_loc[i] = (int)fminf(cap_f, budget_f);
      take_loc[i] = 0;
    }
    if (threadIdx.x == 0) {
      ev[0] = budget0;
      ev[1] = budget0 > 0;
      ev[2] = 0;
    }
    __syncthreads();
  }
  if (ev[1] == 0) return;

  // the shard's top r of where(cap > 0, key, NEG), in top_k's order
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    uint64_t w = ~0ull;
    if (i < n_loc) {
      const float v = cap_loc[i] > 0 ? key_loc[i] : kNeg;
      w = ((uint64_t)topk_desc(v) << 32) | (uint64_t)i;
    }
    keys[i] = w;
  }
  __syncthreads();
  bitonic_sort(keys, p);
  float* pool = pools + (long long)s * 3 * r;
  for (int j = threadIdx.x; j < r; j += blockDim.x) {
    const int li = (int)(keys[j] & 0xFFFFFFFFu);
    pool[j] = cap_loc[li] > 0 ? key_loc[li] : kNeg;
    pool[r + j] = (float)cap_loc[li];
    pool[2 * r + j] = (float)(li + lo);
  }
}

__global__ void __launch_bounds__(kThreads)
bulk_merge_kernel(float* __restrict__ used, const float* __restrict__ ask,
                  int* __restrict__ scratch, int* __restrict__ state,
                  const float* __restrict__ pools, int16_t* __restrict__ counts,
                  int* __restrict__ rounds, int e, int g, int n_loc, int S,
                  int s, int r, int last) {
  __shared__ uint64_t skey[kMaxMerge];
  __shared__ int scap[kMaxMerge];
  __shared__ int sgid[kMaxMerge];
  __shared__ float sval[kMaxMerge];
  __shared__ int warp_tot[32];
  __shared__ float s_thresh;
  __shared__ int s_consumed;
  __shared__ int s_go;
  const int lo = s * n_loc;
  int* st = state;
  if (st[0] != 0) return;
  int* ev = st + 1 + 3 * e;
  if (ev[1] == 0) return;
  int* cap_loc = scratch + n_loc;
  int* take_loc = scratch + 2 * n_loc;
  const int m = S * r;
  int pm = 1;
  while (pm < m) pm <<= 1;
  const int budget = ev[0];

  // the gathered pools, keyed (key desc with -0.0 == +0.0, global id asc)
  for (int j = threadIdx.x; j < pm; j += blockDim.x) {
    uint64_t w = ~0ull;
    if (j < m) {
      const float* pool = pools + (long long)(j / r) * 3 * r;
      const int i = j % r;
      w = ((uint64_t)desc_key(pool[i]) << 32) | (uint64_t)(uint32_t)pool[2 * r + i];
    }
    skey[j] = w;
  }
  if (threadIdx.x == 0) {
    // worst pool entry of the best-covered shard
    float t = pools[r - 1];
    for (int q = 1; q < S; ++q) t = fmaxf(t, pools[(long long)q * 3 * r + r - 1]);
    s_thresh = t;
    s_consumed = 0;
  }
  __syncthreads();
  bitonic_sort(skey, pm);
  // each entry finds its place in the sorted keys (they are unique)
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float* pool = pools + (long long)(j / r) * 3 * r;
    const int i = j % r;
    const float v = pool[i];
    const int gid = (int)pool[2 * r + i];
    const uint64_t w = ((uint64_t)desc_key(v) << 32) | (uint64_t)(uint32_t)gid;
    int a = 0, b = pm;
    while (b - a > 1) {
      const int mid = (a + b) >> 1;
      if (skey[mid] <= w) a = mid; else b = mid;
    }
    sval[a] = v;
    scap[a] = (int)pool[r + i];
    sgid[a] = gid;
  }
  __syncthreads();

  // consume in that order: eligible above the threshold, the best always
  const int chunk = pm >= kThreads ? pm / kThreads : 1;
  const int q0 = threadIdx.x * chunk;
  int caps_e[kMaxMerge / kThreads];  // chunk <= kMaxMerge / kThreads
  int local = 0;
  for (int c = 0; c < chunk; ++c) {
    const int q = q0 + c;
    int ce = 0;
    if (q < m) {
      const bool elig = q == 0 ? sval[0] > kNeg : sval[q] > s_thresh;
      ce = elig ? scap[q] : 0;
    }
    caps_e[c] = ce;
    local += ce;
  }
  int excl = block_exclusive_scan(q0 < pm ? local : 0, warp_tot);
  int consumed = 0;
  for (int c = 0; c < chunk; ++c) {
    const int q = q0 + c;
    if (q >= m) break;
    int take = budget - excl;
    take = take < 0 ? 0 : (take > caps_e[c] ? caps_e[c] : take);
    excl += caps_e[c];
    consumed += take;
    const bool elig = q == 0 ? sval[0] > kNeg : sval[q] > s_thresh;
    const int pos = sgid[q] - lo;
    if (pos >= 0 && pos < n_loc) {
      take_loc[pos] += take;
      if (elig) cap_loc[pos] = 0;
    }
  }
  if (consumed) atomicAdd(&s_consumed, consumed);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int left = budget - s_consumed;
    const int go = left > 0 && sval[0] > kNeg && s_consumed > 0;
    ev[0] = left;
    ev[1] = go;
    ev[2] += 1;
    if (go && last) st[0] = e + 1;  // stall: the host resumes this eval
    s_go = go;
  }
  __syncthreads();
  if (s_go) return;
  // the eval ended: its usage and counts (sharding.py:306-312)
  float a_g[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) a_g[d] = ask[e * kDims + d];
  float* u_s = used;
  for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
    const int t = take_loc[i];
    const float tf = (float)t;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      u_s[i * kDims + d] = __fadd_rn(u_s[i * kDims + d], __fmul_rn(a_g[d], tf));
    }
    counts[(long long)e * n_loc + i] = (int16_t)t;
  }
  if (threadIdx.x == 0) rounds[e] = ev[2];
}

// ---------------------------------------------------------------------------
// B14: the auction restarts on the shards
// ---------------------------------------------------------------------------
//
// Per shard: used_t (T, n_loc, 4), take_t (T, G, n_loc), price (T, n_loc)
// (the shard's slice of the replicated (N,) price: nothing else of it is
// read); state (T, 2 + G) per restart: rounds, go, remaining per eval;
// pools (S, T, 3, G, rl). One CTA per restart (blockIdx.x).

__global__ void __launch_bounds__(kThreads)
joint_bids_kernel(const float* __restrict__ used0,
                  const float* __restrict__ avail,
                  const uint8_t* __restrict__ feas,
                  const float* __restrict__ aff, const float* __restrict__ ask,
                  const int* __restrict__ kk, const float* __restrict__ jits,
                  const float* __restrict__ evict,
                  const float* __restrict__ net_prio, float* used_t,
                  int* take_t, float* price_t, int* state,
                  float* __restrict__ pools, int n_t, int g, int n_loc,
                  int s, int rl, int rounds_cap, int first) {
  __shared__ uint64_t cand[kMaxG][2][kTopR];
  __shared__ float s_ask[kMaxG][kDims];
  __shared__ int s_rem[kMaxG];
  const int t = blockIdx.x;
  const int lo = s * n_loc;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int* st = state + (long long)t * (2 + g);
  float* used = used_t + (long long)t * n_loc * kDims;
  int* take = take_t + (long long)t * g * n_loc;
  float* price = price_t + (long long)t * n_loc;
  const float* av_s = avail;
  const float* ev_s = evict;
  const bool has_evict = evict != nullptr;

  if (first) {
    for (int i = tid; i < n_loc * kDims; i += kThreads) used[i] = used0[i];
    for (int i = tid; i < n_loc; i += kThreads) price[i] = 0.0f;
    for (long long i = tid; i < (long long)g * n_loc; i += kThreads) {
      take[i] = 0;
    }
    if (tid == 0) {
      int any = 0;
      for (int i = 0; i < g; ++i) {
        st[2 + i] = kk[i];
        any |= kk[i] > 0;
      }
      st[0] = 0;
      st[1] = any && rounds_cap > 0;
    }
    __syncthreads();
  }
  if (st[1] == 0) return;
  if (tid < g) {
    s_rem[tid] = st[2 + tid];
#pragma unroll
    for (int d = 0; d < kDims; ++d) s_ask[tid][d] = ask[tid * kDims + d];
  }
  __syncthreads();

  // bids over the shard's nodes and each row's top rl, two warps a row
  const float* jit = jits + (long long)t * g * n_loc;
  for (int row = warp >> 1; row < g; row += kWarps / 2) {
    uint64_t lst[kTopR];
#pragma unroll
    for (int i = 0; i < kTopR; ++i) lst[i] = 0;
    if (s_rem[row] > 0) {
      float a_g[kDims];
#pragma unroll
      for (int d = 0; d < kDims; ++d) a_g[d] = s_ask[row][d];
      const uint8_t* feas_g = feas + (long long)row * n_loc;
      const float* aff_g = aff + (long long)row * n_loc;
      const float* jit_g = jit + (long long)row * n_loc;
      for (int i = (warp & 1) * 32 + lane; i < n_loc; i += 64) {
        if (!feas_g[i]) continue;
        float av[kDims], nu[kDims];
        bool ok = true;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          av[d] = av_s[i * kDims + d];
          const float cap_d =
              has_evict ? __fadd_rn(av[d], ev_s[i * kDims + d]) : av[d];
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
          score = __fdiv_rn(__fadd_rn(fit_score(av, nu), aff_term), divisor);
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
                        over ? preempt_score(net_prio[i])
                             : 0.0f);
          score = __fdiv_rn(num, __fadd_rn(divisor, over ? 1.0f : 0.0f));
        }
        const float bid = __fsub_rn(__fadd_rn(score, jit_g[i]), price[i]);
        topr_insert(lst, bid_key(bid, i));
      }
    }
    warp_topr(lst, cand[row][warp & 1]);
  }
  __syncthreads();

  // merge each row's two halves; write the pool (value, cap, global id),
  // an empty slot as (NEG, 0, a negative id): it surfaces nothing
  if (tid < g) {
    const int row = tid;
    const uint64_t* a = cand[row][0];
    const uint64_t* b = cand[row][1];
    float* pool = pools + ((long long)s * n_t + t) * 3 * g * rl;
    int ia = 0, ib = 0;
    for (int j = 0; j < rl; ++j) {
      uint64_t key;
      if (a[ia] >= b[ib]) {
        key = a[ia++];
      } else {
        key = b[ib++];
      }
      float v = kNeg, cap = 0.0f, gid = (float)(-1 - (s * rl + j));
      if (key != 0) {
        const int li = key_idx(key);
        v = key_val(key);
        float per = INFINITY;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          const float a_d = s_ask[row][d];
          if (a_d > 0.0f) {
            const float av = av_s[li * kDims + d];
            const float cap_d =
                has_evict ? __fadd_rn(av, ev_s[li * kDims + d]) : av;
            per = fminf(per, floorf(__fdiv_rn(
                                 __fsub_rn(cap_d, used[li * kDims + d]), a_d)));
          }
        }
        cap = fmaxf(per, 0.0f);
        gid = (float)(lo + li);
      }
      pool[(0 * g + row) * rl + j] = v;
      pool[(1 * g + row) * rl + j] = cap;
      pool[(2 * g + row) * rl + j] = gid;
    }
  }
}

// merge key of a pool entry: value desc with -0.0 == +0.0, then id asc
// (the id offset by 2^31 so that the negative ids of empty slots order too)
__device__ __forceinline__ uint64_t merge_key(float v, float gid) {
  return ((uint64_t)desc_key(v) << 32) |
         (uint64_t)((uint32_t)(int)gid ^ 0x80000000u);
}

__global__ void __launch_bounds__(kThreads)
joint_merge_kernel(const float* __restrict__ ask,
                   const float* __restrict__ price_eps, float* used_t,
                   int* take_t, float* price_t, int* state,
                   const float* __restrict__ pools, int n_t, int g, int n_loc,
                   int S, int s, int rl, int rg, int rounds_cap) {
  extern __shared__ uint64_t mkey[];   // g x S x rl
  __shared__ float e_val[kMaxJoint];
  __shared__ float e_cap[kMaxJoint];
  __shared__ int e_gid[kMaxJoint];
  __shared__ int e_amt[kMaxJoint];
  __shared__ int e_bids[kMaxJoint];
  __shared__ int s_rem[kMaxG];
  __shared__ int s_progress;
  const int t = blockIdx.x;
  const int lo = s * n_loc;
  const int tid = threadIdx.x;
  int* st = state + (long long)t * (2 + g);
  if (st[1] == 0) return;
  float* used = used_t + (long long)t * n_loc * kDims;
  int* take = take_t + (long long)t * g * n_loc;
  float* price = price_t + (long long)t * n_loc;
  const int m = S * rl;         // entries of a row
  const int n_all = g * m;
  const int n_ent = g * rg;
  if (tid < g) s_rem[tid] = st[2 + tid];
  if (tid == 0) s_progress = 0;
  // entry (row, j) of shard q: pools[q][t][.][row][j]
  for (int x = tid; x < n_all; x += kThreads) {
    const int row = x / m;
    const int j = x % m;
    const float* pool = pools + ((long long)(j / rl) * n_t + t) * 3 * g * rl;
    const int i = row * rl + j % rl;
    mkey[x] = merge_key(pool[i], pool[2 * g * rl + i]);
  }
  __syncthreads();
  // each row's exact global top rg: an entry's rank among its row's keys
  for (int x = tid; x < n_all; x += kThreads) {
    const int row = x / m;
    const uint64_t w = mkey[x];
    int rank = 0;
    for (int y = row * m; y < (row + 1) * m; ++y) rank += mkey[y] < w;
    if (rank < rg) {
      const int j = x % m;
      const float* pool = pools + ((long long)(j / rl) * n_t + t) * 3 * g * rl;
      const int i = row * rl + j % rl;
      const int e = row * rg + rank;
      e_val[e] = pool[i];
      e_cap[e] = pool[g * rl + i];
      e_gid[e] = (int)pool[2 * g * rl + i];
    }
  }
  __syncthreads();

  // winners (each node to its best bid, ties to the lowest eval) and bids
  // per node, over the active entries (value > NEG / 2)
  for (int x = tid; x < n_ent; x += kThreads) {
    const float v = e_val[x];
    const int gid = e_gid[x];
    const int ge = x / rg;
    int bids = 0;
    float cap = 0.0f;
    if (v > kNeg / 2) {
      bool won = true;
      for (int o = 0; o < n_ent; ++o) {
        if (e_gid[o] != gid || !(e_val[o] > kNeg / 2)) continue;
        ++bids;
        const float vo = e_val[o];
        if (vo > v || (vo == v && o / rg < ge)) won = false;
      }
      if (won) cap = e_cap[x];
    }
    e_bids[x] = bids;
    e_amt[x] = 0;
    e_cap[x] = cap;  // now the won capacity, 0 where not won
  }
  __syncthreads();

  // each row spends its demand over its won nodes in score order:
  // amt = clip(remaining - (cumsum(cap) - cap), 0, cap), NaN -> 0
  if (tid < g) {
    const float rem_f = (float)s_rem[tid];
    float cum = 0.0f;
    int total = 0;
    for (int j = 0; j < rg; ++j) {
      const int x = tid * rg + j;
      const float c = e_cap[x];
      cum = __fadd_rn(cum, c);
      const float y = __fsub_rn(rem_f, __fsub_rn(cum, c));
      const int amt = (int)fminf(fmaxf(y, 0.0f), c);
      e_amt[x] = amt;
      total += amt;
    }
    s_rem[tid] -= total;
    if (total > 0) s_progress = 1;
  }
  __syncthreads();

  // the shard's own rows: usage, take, and the price of contested, drained
  // nodes (one winner per node, so no two threads touch one row)
  const float eps = price_eps[t];
  for (int x = tid; x < n_ent; x += kThreads) {
    const int pos = e_gid[x] - lo;
    if (pos < 0 || pos >= n_loc) continue;
    const int amt = e_amt[x];
    const int row = x / rg;
    if (amt > 0) {
      const float af = (float)amt;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        used[pos * kDims + d] = __fadd_rn(
            used[pos * kDims + d], __fmul_rn(ask[row * kDims + d], af));
      }
      take[(long long)row * n_loc + pos] += amt;
    }
    const float cap = e_cap[x];
    if (cap > 0.0f && (float)amt >= cap && e_bids[x] > 1) {
      price[pos] = __fadd_rn(price[pos], eps);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    for (int i = 0; i < g; ++i) {
      st[2 + i] = s_rem[i];
      any |= s_rem[i] > 0;
    }
    st[0] += 1;
    st[1] = st[0] < rounds_cap && s_progress && any;
  }
}

// per shard and arm: contrib[s][arm][i] = (placed on node i) x fitness of
// its final usage, and the shard's placed total; arm < T a restart, arm T
// the greedy arm
__global__ void __launch_bounds__(kThreads)
joint_contrib_kernel(const float* __restrict__ avail,
                     const float* __restrict__ used_t,
                     const int* __restrict__ take_t,
                     const float* __restrict__ used_g,
                     const int16_t* __restrict__ counts_g,
                     float* __restrict__ contrib, int* __restrict__ placed,
                     int n_t, int g, int n_loc, int s) {
  __shared__ int s_placed;
  const int arm = blockIdx.x;
  const bool greedy = arm == n_t;
  const float* used = greedy ? used_g : used_t + (long long)arm * n_loc * kDims;
  const float* av = avail;
  if (threadIdx.x == 0) s_placed = 0;
  __syncthreads();
  int local = 0;
  float* out = contrib + ((long long)s * (n_t + 1) + arm) * n_loc;
  for (int i = threadIdx.x; i < n_loc; i += blockDim.x) {
    int c = 0;
    for (int row = 0; row < g; ++row) {
      const long long at = (long long)row * n_loc + i;
      c += greedy ? (int)counts_g[at]
                  : take_t[(long long)arm * g * n_loc + at];
    }
    out[i] = __fmul_rn((float)c, fit_score(av + i * kDims, used + i * kDims));
    local += c;
  }
  if (local) atomicAdd(&s_placed, local);
  __syncthreads();
  if (threadIdx.x == 0) placed[s * (n_t + 1) + arm] = s_placed;
}

// every shard scores the T + 1 arms over the gathered contributions in the
// global node order (the pairwise tree), picks as solve_batch does, and
// copies its own rows of the chosen arm
__global__ void __launch_bounds__(kThreads)
joint_pick_kernel(const float* __restrict__ contrib,
                  const int* __restrict__ placed,
                  const int* __restrict__ state,
                  const int* __restrict__ rounds_g,
                  const float* __restrict__ used_t,
                  const int* __restrict__ take_t,
                  const float* __restrict__ used_g,
                  const int16_t* __restrict__ counts_g, float* used_out,
                  int16_t* counts_out, float* info, int* gathers, int n_t,
                  int g, int n, int n_loc, int S, int p) {
  extern __shared__ float tree[];
  int best_t = 0, best_placed = 0, placed_g = 0;
  float best_score = 0.0f, score_g = 0.0f;
  for (int arm = 0; arm <= n_t; ++arm) {
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
      tree[j] = j < n ? contrib[((long long)(j / n_loc) * (n_t + 1) + arm) *
                                    n_loc + j % n_loc]
                      : 0.0f;
    }
    __syncthreads();
    const float score = block_pairwise_sum<kThreads, kMaxTree / 2 / kThreads>(
        tree, p);
    int pl = 0;
    for (int q = 0; q < S; ++q) pl += placed[q * (n_t + 1) + arm];
    if (arm == n_t) {
      score_g = score;
      placed_g = pl;
    } else if (arm == 0 || pl > best_placed ||
               (pl == best_placed && score > best_score)) {
      best_t = arm;
      best_score = score;
      best_placed = pl;
    }
  }
  const bool pick_a = best_placed > placed_g ||
                      (best_placed == placed_g && best_score > score_g);
  const float* src =
      pick_a ? used_t + (long long)best_t * n_loc * kDims : used_g;
  for (int i = threadIdx.x; i < n_loc * kDims; i += blockDim.x) {
    used_out[i] = src[i];
  }
  for (long long x = threadIdx.x; x < (long long)g * n_loc; x += blockDim.x) {
    counts_out[x] = pick_a ? (int16_t)take_t[(long long)best_t * g * n_loc + x]
                           : counts_g[x];
  }
  if (threadIdx.x == 0) {
    const int* st = state;  // the restarts: rounds at [t][0]
    int gat = 1;
    for (int e = 0; e < g; ++e) gat += rounds_g[e];
    for (int t = 0; t < n_t; ++t) gat += st[t * (2 + g)] + 1;
    *gathers = gat;
    info[0] = best_score;
    info[1] = score_g;
    info[2] = (float)best_placed;
    info[3] = (float)placed_g;
    info[4] = (float)st[best_t * (2 + g)];
    info[5] = pick_a ? 1.0f : 0.0f;
  }
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

// B15 for all S shards from one host call: shard s's launch on card
// ordinals[s] and streams[s], that card made current only when it is not,
// the caller's device current again at the end. Returns the first error.
extern "C" int nt_scatter_shards(void* const* used, const void* const* idx,
                                 const void* const* delta,
                                 const int* ordinals, int shards, int b,
                                 int n_loc, int clamp,
                                 void* const* streams) {
  if (shards < 1 || n_loc < 1 || b < 0) return (int)cudaErrorInvalidValue;
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int cur = caller;
  for (int s = 0; s < shards && err == cudaSuccess; ++s) {
    if (ordinals[s] != cur) {
      err = cudaSetDevice(ordinals[s]);
      if (err != cudaSuccess) break;
      cur = ordinals[s];
    }
    const cudaStream_t stream = (cudaStream_t)streams[s];
    if (clamp) {
      scatter_clamp_shard_kernel<<<1, threads, 0, stream>>>(
          (float*)used[s], (const int*)idx[s], (const float*)delta[s], b,
          n_loc, s);
    } else if (b > 0) {
      scatter_shard_kernel<<<(b * kDims + threads - 1) / threads, threads, 0,
                             stream>>>(
          (float*)used[s], (const int*)idx[s], (const float*)delta[s], b,
          n_loc, s);
    }
    err = cudaGetLastError();
  }
  if (cur != caller) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

extern "C" int nt_bulk_shard_pool(const void* used, const void* avail,
                                  const void* feas, const void* aff,
                                  const void* ask, const void* k,
                                  const void* jit, void* scratch, void* state,
                                  void* pools, int e, int g, int n_loc,
                                  int s, int r, int first, void* stream) {
  if (s < 0 || n_loc < 1 || r < 1 || r > n_loc || e < 0 || e >= g)
    return (int)cudaErrorInvalidValue;
  const int p = pow2_at_least(n_loc);
  const size_t smem = (size_t)p * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      bulk_pool_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bulk_pool_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)used, (const float*)avail, (const uint8_t*)feas,
      (const float*)aff, (const float*)ask, (const int*)k, (const float*)jit,
      (int*)scratch, (int*)state, (float*)pools, e, g, n_loc, s, r, first,
      p);
  return (int)cudaGetLastError();
}

extern "C" int nt_bulk_shard_merge(void* used, const void* ask, void* scratch,
                                   void* state, const void* pools,
                                   void* counts, void* rounds, int e, int g,
                                   int n_loc, int S, int s, int r, int last,
                                   void* stream) {
  if (s < 0 || s >= S || r < 1 || S * r > kMaxMerge || e < 0 || e >= g)
    return (int)cudaErrorInvalidValue;
  bulk_merge_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)used, (const float*)ask, (int*)scratch, (int*)state,
      (const float*)pools, (int16_t*)counts, (int*)rounds, e, g, n_loc, S, s,
      r, last);
  return (int)cudaGetLastError();
}

extern "C" int nt_joint_shard_bids(const void* used0, const void* avail,
                                   const void* feas, const void* aff,
                                   const void* ask, const void* k,
                                   const void* jits, const void* evict,
                                   const void* net_prio, void* used_t,
                                   void* take_t, void* price_t, void* state,
                                   void* pools, int n_t, int g, int n_loc,
                                   int s, int rl, int rounds_cap, int first,
                                   void* stream) {
  if (s < 0 || n_t < 1 || g < 1 || g > kMaxG || rl < 1 || rl > kTopR ||
      rl > n_loc)
    return (int)cudaErrorInvalidValue;
  joint_bids_kernel<<<n_t, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)used0, (const float*)avail, (const uint8_t*)feas,
      (const float*)aff, (const float*)ask, (const int*)k,
      (const float*)jits, (const float*)evict, (const float*)net_prio,
      (float*)used_t, (int*)take_t, (float*)price_t, (int*)state,
      (float*)pools, n_t, g, n_loc, s, rl, rounds_cap, first);
  return (int)cudaGetLastError();
}

extern "C" int nt_joint_shard_merge(const void* ask, const void* price_eps,
                                    void* used_t, void* take_t,
                                    void* price_t, void* state,
                                    const void* pools, int n_t, int g,
                                    int n_loc, int S, int s, int rl, int rg,
                                    int rounds_cap, void* stream) {
  if (s < 0 || s >= S || n_t < 1 || g < 1 || g > kMaxG || rg < 1 ||
      rg > kTopR || g * rg > kMaxJoint || rg > S * rl)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)g * S * rl * sizeof(uint64_t);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      joint_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  joint_merge_kernel<<<n_t, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)ask, (const float*)price_eps, (float*)used_t,
      (int*)take_t, (float*)price_t, (int*)state, (const float*)pools, n_t,
      g, n_loc, S, s, rl, rg, rounds_cap);
  return (int)cudaGetLastError();
}

extern "C" int nt_joint_shard_contrib(const void* avail, const void* used_t,
                                      const void* take_t, const void* used_g,
                                      const void* counts_g, void* contrib,
                                      void* placed, int n_t, int g, int n_loc,
                                      int s, void* stream) {
  if (s < 0 || n_t < 1 || g < 1) return (int)cudaErrorInvalidValue;
  joint_contrib_kernel<<<n_t + 1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)used_t, (const int*)take_t,
      (const float*)used_g, (const int16_t*)counts_g, (float*)contrib,
      (int*)placed, n_t, g, n_loc, s);
  return (int)cudaGetLastError();
}

extern "C" int nt_joint_shard_pick(const void* contrib, const void* placed,
                                   const void* state, const void* rounds_g,
                                   const void* used_t, const void* take_t,
                                   const void* used_g, const void* counts_g,
                                   void* used_out, void* counts_out,
                                   void* info, void* gathers, int n_t, int g,
                                   int n, int n_loc, int S, void* stream) {
  if (n_t < 1 || g < 1 || n != S * n_loc)
    return (int)cudaErrorInvalidValue;
  const int p = pow2_at_least(n);
  if (p > kMaxTree) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      joint_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  joint_pick_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)contrib, (const int*)placed, (const int*)state,
      (const int*)rounds_g, (const float*)used_t, (const int*)take_t,
      (const float*)used_g, (const int16_t*)counts_g, (float*)used_out,
      (int16_t*)counts_out, (float*)info, (int*)gathers, n_t, g, n, n_loc, S,
      p);
  return (int)cudaGetLastError();
}
