// B11's scan kernel and its instances (bulk_scan.cu states what it
// computes and how), shared by bulk_scan.cu (the entry points, the
// narrow instances and B11') and wide/bulk_scan.cu (the wide instances).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "select.cuh"
#include "sort.cuh"
#include "threefry.cuh"

namespace {

using namespace nt_score;
using nt_select::kRadixWords;
using nt_select::may_take;
using nt_select::Positions;
using nt_select::PositionsOf;
using nt_select::single_taker;
using nt_select::Summary;
using nt_select::summarize;
using nt_select::take_at;
using nt_select::Threshold;
using nt_select::threshold_base;
using nt_select::threshold_radix;
using nt_select::threshold_select;
using nt_sort::desc_key;
using nt_threefry::threefry2x32;
using nt_threefry::threefry_bits;

constexpr int kThreads = 1024;
constexpr int kMaxNodes = 65536;     // B11's ceiling (ROADMAP A11d)
constexpr int kSharedNodes = 16384;  // keys and caps in shared memory
constexpr int kMaxPermNodes = 65536; // B11' (its values are 16-bit)
constexpr int kMaxBatch = 65535;     // cap field
constexpr size_t kMaxSmem = 232448;  // a block's shared memory

// The scan's threads: 32 a warp, one a position up to 1,024 positions,
// else 1,024 with `chunk` positions each; and the slots of its position
// arrays (see select.cuh's Positions)
__host__ __device__ inline int scan_threads(int n) {
  return n >= kThreads ? kThreads : (n + 31) / 32 * 32;
}
__host__ __device__ inline int scan_slots(int n) {
  return n <= kThreads ? n : (n + kThreads - 1) / kThreads * kThreads;
}

// Bytes of the scan's shared work arrays after the count tables: the
// reductions' words (10 a warp), block_exclusive_scan's (1 a warp), the
// keys (u32) and caps (u16, rounded up to a word) of every slot
__host__ __device__ inline size_t scan_work_bytes(int n) {
  const int nw = scan_threads(n) / 32;
  return 4 * (size_t)(11 * nw) + 4 * (size_t)scan_slots(n) +
         4 * (((size_t)scan_slots(n) + 1) / 2);
}

// Above kSharedNodes positions ("wide") a thread holds 17-64 of them:
// their keys and caps, like the cached terms, live in the global scratch,
// and shared memory holds the reductions' words and threshold_radix's
// histogram
__host__ __device__ inline bool scan_wide(int n) { return n > kSharedNodes; }
__host__ __device__ inline size_t wide_work_bytes(int n) {
  return 4 * (size_t)(11 * (scan_threads(n) / 32) + kRadixWords);
}

// Bytes of the cached terms of every slot and the boost table (S > 0):
// boost[S x V] f32 | head[slots] f32 | meta[slots], sv[S x slots] u16
__host__ __device__ inline size_t scan_cache_bytes(const Dims& dm, int n) {
  const size_t slots = scan_slots(n);
  return 4 * (size_t)dm.s * dm.v + 4 * slots + 2 * slots * (1 + dm.s);
}

// Their room in the global scratch, whole words (none without spreads)
__host__ __device__ inline size_t scan_cache_room(const Dims& dm, int n) {
  return dm.s > 0 ? (scan_cache_bytes(dm, n) + 3) / 4 * 4 : 0;
}

// Bytes of the keys (u32) and caps (u16) of every slot in the scratch
__host__ __device__ inline size_t scan_pos_bytes(int n) {
  return 4 * (size_t)scan_slots(n) + 4 * (((size_t)scan_slots(n) + 1) / 2);
}

// A position's cap, uncapped by the budget (clipped at the 16-bit field:
// a budget never exceeds it)
template <bool kWideDims, class Nodes>
__device__ __forceinline__ uint32_t node_cap(const Nodes& nd, int j,
                                             const Dims& dm,
                                             const Scalars& sc, bool ok,
                                             bool single) {
  float per = INFINITY;
  if constexpr (kWideDims) {
    for (int k = 0; k < dm.d; ++k) {
      const float a = sc.askp[k];
      if (a > 0.0f) {
        const float free_k = __fsub_rn(nd.avail(j, k), nd.used(j, k));
        per = fminf(per, floorf(__fdiv_rn(free_k, a)));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxDims; ++k) {
      if (k < dm.d && sc.ask[k] > 0.0f) {
        const float free_k = __fsub_rn(nd.avail(j, k), nd.used(j, k));
        per = fminf(per, floorf(__fdiv_rn(free_k, sc.ask[k])));
      }
    }
  }
  float cap_f = fmaxf(per, 0.0f);
  if (!ok) cap_f = 0.0f;
  if (single) cap_f = fminf(cap_f, 1.0f);
  return (uint32_t)fminf(cap_f, (float)kMaxBatch);
}

// Rescore a node from its columns into slot `slot`: its cap, and its key
// (S == 0) or its cached terms (S > 0: keyed each step by cached_score).
template <bool kWideDims, class Nodes, class Ps>
__device__ __forceinline__ void rescore(const Nodes& nd, int j,
                                        const Ps& ps, int slot,
                                        const Dims& dm, const Scalars& sc,
                                        bool single, const NodeCache& cache) {
  const NodeTerms t = node_terms<kWideDims>(nd, j, dm, sc);
  const bool ok = (t.meta & kOkLocal) != 0;
  ps.cap[slot] = (uint16_t)node_cap<kWideDims>(nd, j, dm, sc, ok, single);
  if (dm.s > 0) {
    cache.head[slot] = t.head;
    cache.meta[slot] = t.meta;
  } else {
    ps.key[slot] = desc_key(ok ? finish_score(t.head, t.meta, 0.0f) : kNeg);
  }
}

// Place `take` at position j: usage, placement counts, taken, spread
// value counts, from one read of its columns; then rescore it. (The wide
// instance writes each column and reads it back in the rescore.)
template <bool kWideDims, class Ps>
__device__ inline void commit(const ScratchNodes& nd, int j,
                              const Ps& ps, int slot, int take,
                              const Dims& dm, const Scalars& sc, bool single,
                              const Tables& tb, int* taken,
                              const NodeCache& cache) {
  if constexpr (kWideDims) {
    const float tf = (float)take;
    for (int k = 0; k < dm.d; ++k) {
      nd.f[nd.at(dm.d + k, j)] =
          __fadd_rn(nd.used(j, k), __fmul_rn(sc.askp[k], tf));
    }
    nd.i32[nd.at(2 * dm.d, j)] += take;
    nd.i32[nd.at(2 * dm.d + 1, j)] += take;
    taken[j] += take;
    for (int k = 0; k < dm.s; ++k) {
      if (nd.sok(j, k)) atomicAdd(&tb.scnt[k * dm.v + nd.svid(j, k)], take);
    }
    rescore<true>(nd, j, ps, slot, dm, sc, single, cache);
    return;
  }
  NodeRow row = load_row(nd, j, dm.d);
  const int before = taken[j];
  const float tf = (float)take;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < dm.d) {
      row.us[k] = __fadd_rn(row.us[k], __fmul_rn(sc.ask[k], tf));
      nd.f[nd.at(dm.d + k, j)] = row.us[k];
    }
  }
  row.ptg_ += take;
  row.pjob_ += take;
  nd.i32[nd.at(2 * dm.d, j)] = row.ptg_;
  nd.i32[nd.at(2 * dm.d + 1, j)] = row.pjob_;
  taken[j] = before + take;
  for (int k = 0; k < dm.s; ++k) {
    if (nd.sok(j, k)) atomicAdd(&tb.scnt[k * dm.v + nd.svid(j, k)], take);
  }
  rescore<false>(row, 0, ps, slot, dm, sc, single, cache);
}

// kQ: the positions a thread holds at most (16: keys and caps in shared
// memory, the fill's level by threshold_select; 32 or 64: in the scratch,
// by threshold_radix); kShared: the cached terms in shared memory;
// kWideDims: score.cuh's wide instance (D > 8 or S > 8)
template <int kQ, bool kShared, bool kWideDims>
__global__ void __launch_bounds__(kThreads)
bulk_scan_kernel(const float* __restrict__ avail,
                 const float* __restrict__ dyn,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ aff,
                 const float* __restrict__ dev,
                 const int* __restrict__ tie_perm,
                 const float* __restrict__ spread_node,
                 const float* __restrict__ spread_tab,
                 const float* __restrict__ spread_meta,
                 const float* __restrict__ scalars,
                 float* __restrict__ scratch, int* __restrict__ out, Dims dm,
                 int k_total, int batch, int n_steps) {
  extern __shared__ __align__(16) char smem[];
  constexpr bool kWide = kQ > Positions::kMaxQ;

  const int n = dm.n, d = dm.d, s = dm.s;
  const int nw = blockDim.x >> 5;
  const Tables tb = carve_tables(smem, dm);
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + table_bytes(dm));
  int* warp_tot = reinterpret_cast<int*>(red + 10 * nw);
  uint32_t* hist = reinterpret_cast<uint32_t*>(warp_tot + nw);  // kWide
  const int slots = scan_slots(n);
  load_tables(tb, dm, spread_tab, spread_meta, nullptr);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, 0};
  int* taken = nd.i32 + (long long)(2 * d + 6 + 2 * s) * n;
  char* base = kShared ? smem + table_bytes(dm) + scan_work_bytes(n)
                       : reinterpret_cast<char*>(taken + n);
  uint32_t* keys =
      kWide ? reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(taken + n) +
                                          scan_cache_room(dm, n))
            : reinterpret_cast<uint32_t*>(warp_tot + nw);
  const PositionsOf<kQ> ps{keys, reinterpret_cast<uint16_t*>(keys + slots),
                           n <= kThreads ? 1 : slots / kThreads, n};
  if (kWide) {
    for (int i = threadIdx.x; i < kRadixWords; i += blockDim.x) hist[i] = 0u;
  }
  float* boost = reinterpret_cast<float*>(base);
  float* head = boost + s * dm.v;
  uint16_t* meta = reinterpret_cast<uint16_t*>(head + slots);
  const NodeCache cache{head, meta, meta + slots, nullptr, slots};

  // gather every per-node column into permuted (tie_perm) order
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int i = tie_perm[j];
    const float* dyn_i = dyn + (long long)i * (d + 2);
    for (int k = 0; k < d; ++k) {
      scratch[nd.at(k, j)] = avail[(long long)i * d + k];
      scratch[nd.at(d + k, j)] = dyn_i[k];
    }
    nd.i32[nd.at(2 * d, j)] = (int)dyn_i[d];
    nd.i32[nd.at(2 * d + 1, j)] = (int)dyn_i[d + 1];
    scratch[nd.at(2 * d + 2, j)] = feas[i] ? 1.0f : 0.0f;
    scratch[nd.at(2 * d + 3, j)] = aff[i];
    scratch[nd.at(2 * d + 4, j)] = dev != nullptr ? dev[i] : 0.0f;
    nd.i32[nd.at(2 * d + 5, j)] = i;
    for (int k = 0; k < s; ++k) {
      nd.i32[nd.at(2 * d + 6 + k, j)] = (int)spread_node[(long long)k * n + i];
      scratch[nd.at(2 * d + 6 + s + k, j)] =
          spread_node[(long long)(s + k) * n + i];
    }
    taken[j] = 0;
  }
  __syncthreads();

  // each thread scores its own positions (their columns are in the
  // scratch now)
  const bool single = sc.dh_job || sc.dh_tg || sc.spread_alg;
  const int first = (int)threadIdx.x * ps.chunk;
  const int mine = ps.count();
  for (int q = 0; q < mine; ++q) {
    const int j = first + q;
    const int slot = ps.slot(q);
    for (int k = 0; k < s; ++k) {
      cache.sv[k * slots + slot] =
          nd.sok(j, k) ? (uint16_t)nd.svid(j, k) : kNoValue;
    }
    rescore<kWideDims>(nd, j, ps, slot, dm, sc, single, cache);
  }

  int parity = 0;
  int remaining = k_total;
  int summed_for = -1;  // the budget of the summary
  Summary sm{};
  for (int step = 0; step < n_steps && remaining > 0; ++step) {
    const int budget = remaining < batch ? remaining : batch;
    if (s > 0) {
      __syncthreads();  // the last step's atomics and cached terms
      value_tables<kWideDims>(tb, dm, -1.0f, boost, nullptr, nullptr);
      __syncthreads();
      for (int q = 0; q < mine; ++q) {
        ps.key[ps.slot(q)] = desc_key(
            cached_score<kWideDims>(cache, ps.slot(q), dm, boost, nullptr));
      }
      summed_for = -1;
    }
    if (budget != summed_for) {
      sm = summarize(ps, (uint32_t)budget);
      summed_for = budget;
    }
    Threshold th;
    if constexpr (kWide) {
      th = threshold_radix(ps, sm, (uint32_t)budget, hist, red, parity);
    } else {
      th = threshold_select(ps, sm, (uint32_t)budget, red, parity);
    }
    long long excl =
        threshold_base(ps, sm, th, (uint32_t)budget, warp_tot);
    const int one = single_taker(sm, th);
    if (one >= 0) {
      // the level's only position, and nothing of this thread below it
      const int slot = ps.slot(one);
      const uint32_t take = take_at(ps.key[slot], ps.cap[slot], th,
                                    (uint32_t)budget, excl);
      if (take) {
        commit<kWideDims>(nd, first + one, ps, slot, (int)take, dm, sc,
                          single, tb, taken, cache);
        sm = summarize(ps, (uint32_t)budget);
      }
    } else if (may_take(sm, th)) {
      bool moved = false;
      for (int q = 0; q < mine; ++q) {
        const int slot = ps.slot(q);
        const uint32_t take = take_at(ps.key[slot], ps.cap[slot], th,
                                      (uint32_t)budget, excl);
        if (take) {
          commit<kWideDims>(nd, first + q, ps, slot, (int)take, dm, sc,
                            single, tb, taken, cache);
          moved = true;
        }
      }
      if (moved) sm = summarize(ps, (uint32_t)budget);
    }
    const int placed = th.all ? (int)th.total : budget;
    // nothing placed: the carry did not move, so no later step places
    remaining = placed > 0 ? remaining - placed : 0;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    out[nd.orig(j)] = taken[j];
  }
}

using ScanKernel = void (*)(const float*, const float*, const uint8_t*,
                            const float*, const float*, const int*,
                            const float*, const float*, const float*,
                            const float*, float*, int*, Dims, int, int, int);

// the instance for n positions: 16 a thread at most with the keys in
// shared memory (the cached terms there too where they fit), else 32 or
// 64 a thread with everything in the scratch; of the shape's width
template <bool kWideDims>
ScanKernel scan_kernel_of(int n, bool cache_in_smem) {
  if (!scan_wide(n)) {
    return cache_in_smem ? bulk_scan_kernel<16, true, kWideDims>
                         : bulk_scan_kernel<16, false, kWideDims>;
  }
  return scan_slots(n) <= 32 * kThreads
             ? bulk_scan_kernel<32, false, kWideDims>
             : bulk_scan_kernel<64, false, kWideDims>;
}

}  // namespace

namespace nt_bulk {

// The wide instance for n positions (scan_kernel_of<true>), in
// wide/bulk_scan.cu: a translation unit of its own, which nvcc compiles
// beside bulk_scan.cu and the linker puts into the same library
ScanKernel wide_kernel(int n, bool cache_in_smem);

}  // namespace nt_bulk
