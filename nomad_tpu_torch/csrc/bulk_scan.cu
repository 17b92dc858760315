// B11: the count-based bulk scan (solve_bulk and solve_bulk_fused), and
// B11': the tie-break permutation the fused form draws on the device.
//
// Replaces: _bulk_scan / solve_bulk (nomad_tpu/tensor/kernels.py:494-594),
// solve_bulk_fused (kernels.py:597-629), and its
// jax.random.permutation(jax.random.PRNGKey(seed), n) (kernels.py:618-619).
// The plain torch versions are solve_bulk_ref / solve_bulk_fused_ref in
// tensor/kernels.py and permutation_ref in tensor/prng.py.
//
// nt_bulk_scan computes, in tie-permuted node space (node j of the scan is
// canonical node tie_perm[j]), up to n_steps steps of at most `batch`
// placements of one task group, with remaining = k_total:
//   score   = B8 at every node (score.cuh; no node penalty, lowest explicit
//             boost -1, no distinct_property tables)
//   budget  = min(remaining, batch)
//   cap     = max(0, min_{ask_d > 0} floor((avail - used) / ask_d)), +inf
//             for an all-zero ask; 0 where score == NEG; at most 1 under
//             distinct_hosts or WorstFit; at most budget
//   order   = positions by score descending, position ascending (the
//             reference's stable argsort(-score), -0.0 equal to +0.0)
//   take    = clip(budget - exclusive_cumsum(cap in order), 0, cap)
//   used   += ask * take; placed_tg, placed_job += take; each spread's
//             value count += take where the node has the value;
//             remaining -= sum(take)
// and returns the per-node totals mapped back to canonical order
// (out[tie_perm[j]] = taken[j]), int32: k may exceed the int16 counts of
// the solver service (MAX_K = 32,767), which is why this route exists.
//
// Early exit, exact: a step that takes nothing leaves the carry unchanged,
// so every later step takes nothing too; the scan stops there or when
// remaining reaches 0. The reference runs all n_steps = k_pad / batch.
//
// nt_tie_perm computes jax.random.permutation(PRNGKey(seed), n) for a
// 32-bit seed: the key is (0, seed); each of the `rounds` rounds (1 for
// n <= 1,625, 2 up to ~2.6M, computed by the caller as _shuffle does) is
// key, subkey = split(key), one 32-bit threefry draw per position from the
// subkey, and a stable sort of the current sequence by those draws.
//
// Bound on the H100: neither bytes nor operations. B11 reads ~40 bytes a
// node and writes 4 (under 1 MB at N_pad 16,384, a fraction of a
// microsecond of HBM time); the work it needs is one score per node plus,
// per active step, a rescore and an ordering update of the few nodes that
// took placements. The time goes to the steps running one after another
// on one SM, each a few block-wide reductions behind barriers. B11' is
// ~2 x 20 threefry rounds and a sort of n keys; its time is the one-CTA
// sort.
//
// Design (B11): one CTA of 1024 threads runs the whole scan, so the carry
// chain needs only __syncthreads. The CTA gathers every per-node column into
// permuted order in a global scratch buffer (score.cuh's ScratchNodes
// layout, column-major, L2-resident), which also holds the usage and
// placement-count carry and the taken counts; the spread value tables live
// in shared memory and take their updates by integer atomics. Thread t owns
// the positions t x chunk .. t x chunk + chunk - 1 (chunk = N / 1024 rounded
// up, at most 16) and keeps each one's order key, desc_key(score)
// (sort.cuh), and its cap uncapped by the budget (16 bits, two to a word) in
// registers from step to step. A step clips the caps to the budget, finds
// the fill's level with select.cuh (threshold_select: a few block-wide
// reductions, no sort), takes the fill there (threshold_base and take_at:
// one block scan), and the owner of each position that took updates its
// node's carry and rescores it (score.cuh's node_terms). With no spread (S
// == 0, the fused form) nothing else's score moves. With spreads every score
// moves through the value counts: the owner keeps the node's cached terms
// (in shared memory, or in the scratch where they do not fit, kShared false)
// and each step rebuilds the value tables and recomputes every key with
// cached_score. B11' sorts (draw << 32) | position, which is stable by
// construction, and carries the values beside the keys (192 KB at 16,384).
// Neither kernel calls a library sort or scan.
//
// Arithmetic: B8 is score.cuh's, bit for bit the plain version's; the cap
// uses __fsub_rn, __fdiv_rn and floorf; the carry update is
// __fadd_rn(used, __fmul_rn(ask, take)), the reference's multiply-add order
// (built with --fmad=false, no fast math). The counts equal the plain
// version's exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "select.cuh"
#include "sort.cuh"
#include "threefry.cuh"

namespace {

using namespace nt_score;
using nt_select::may_take;
using nt_select::Positions;
using nt_select::single_taker;
using nt_select::Summary;
using nt_select::summarize;
using nt_select::take_at;
using nt_select::Threshold;
using nt_select::threshold_base;
using nt_select::threshold_select;
using nt_sort::bitonic_sort;
using nt_sort::desc_key;
using nt_threefry::threefry2x32;
using nt_threefry::threefry_bits;

constexpr int kThreads = 1024;
constexpr int kMaxNodes = 16384;     // the fallbacks' ceiling (ROADMAP A11b)
constexpr int kMaxBatch = 65535;     // cap field
constexpr size_t kMaxSmem = 232448;  // a block's shared memory

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

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

// Bytes of the cached terms of every slot and the boost table (S > 0):
// boost[S x V] f32 | head[slots] f32 | meta[slots], sv[S x slots] u16
__host__ __device__ inline size_t scan_cache_bytes(const Dims& dm, int n) {
  const size_t slots = scan_slots(n);
  return 4 * (size_t)dm.s * dm.v + 4 * slots + 2 * slots * (1 + dm.s);
}

// A position's cap, uncapped by the budget (clipped at the 16-bit field:
// a budget never exceeds it)
template <class Nodes>
__device__ __forceinline__ uint32_t node_cap(const Nodes& nd, int j,
                                             const Dims& dm,
                                             const Scalars& sc, bool ok,
                                             bool single) {
  float per = INFINITY;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < dm.d && sc.ask[k] > 0.0f) {
      const float free_k = __fsub_rn(nd.avail(j, k), nd.used(j, k));
      per = fminf(per, floorf(__fdiv_rn(free_k, sc.ask[k])));
    }
  }
  float cap_f = fmaxf(per, 0.0f);
  if (!ok) cap_f = 0.0f;
  if (single) cap_f = fminf(cap_f, 1.0f);
  return (uint32_t)fminf(cap_f, (float)kMaxBatch);
}

// Rescore a node from its columns into slot `slot`: its cap, and its key
// (S == 0) or its cached terms (S > 0: keyed each step by cached_score).
template <class Nodes>
__device__ __forceinline__ void rescore(const Nodes& nd, int j,
                                        const Positions& ps, int slot,
                                        const Dims& dm, const Scalars& sc,
                                        bool single, const NodeCache& cache) {
  const NodeTerms t = node_terms(nd, j, dm, sc);
  const bool ok = (t.meta & kOkLocal) != 0;
  ps.cap[slot] = (uint16_t)node_cap(nd, j, dm, sc, ok, single);
  if (dm.s > 0) {
    cache.head[slot] = t.head;
    cache.meta[slot] = t.meta;
  } else {
    ps.key[slot] = desc_key(ok ? finish_score(t.head, t.meta, 0.0f) : kNeg);
  }
}

// Place `take` at position j: usage, placement counts, taken, spread
// value counts, from one read of its columns; then rescore it.
__device__ inline void commit(const ScratchNodes& nd, int j,
                              const Positions& ps, int slot, int take,
                              const Dims& dm, const Scalars& sc, bool single,
                              const Tables& tb, int* taken,
                              const NodeCache& cache) {
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
  rescore(row, 0, ps, slot, dm, sc, single, cache);
}

template <bool kShared>
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

  const int n = dm.n, d = dm.d, s = dm.s;
  const int nw = blockDim.x >> 5;
  const Tables tb = carve_tables(smem, dm);
  uint32_t* red = reinterpret_cast<uint32_t*>(smem + table_bytes(dm));
  int* warp_tot = reinterpret_cast<int*>(red + 10 * nw);
  const int slots = scan_slots(n);
  const Positions ps{reinterpret_cast<uint32_t*>(warp_tot + nw),
                     reinterpret_cast<uint16_t*>(
                         reinterpret_cast<uint32_t*>(warp_tot + nw) + slots),
                     n <= kThreads ? 1 : slots / kThreads, n};
  load_tables(tb, dm, spread_tab, spread_meta, nullptr);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, 0};
  int* taken = nd.i32 + (long long)(2 * d + 6 + 2 * s) * n;
  char* base = kShared ? smem + table_bytes(dm) + scan_work_bytes(n)
                       : reinterpret_cast<char*>(taken + n);
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
    rescore(nd, j, ps, slot, dm, sc, single, cache);
  }

  int parity = 0;
  int remaining = k_total;
  int summed_for = -1;  // the budget of the summary
  Summary sm{};
  for (int step = 0; step < n_steps && remaining > 0; ++step) {
    const int budget = remaining < batch ? remaining : batch;
    if (s > 0) {
      __syncthreads();  // the last step's atomics and cached terms
      value_tables(tb, dm, -1.0f, boost, nullptr, nullptr);
      __syncthreads();
      for (int q = 0; q < mine; ++q) {
        ps.key[ps.slot(q)] =
            desc_key(cached_score(cache, ps.slot(q), dm, boost, nullptr));
      }
      summed_for = -1;
    }
    if (budget != summed_for) {
      sm = summarize(ps, (uint32_t)budget);
      summed_for = budget;
    }
    const Threshold th =
        threshold_select(ps, sm, (uint32_t)budget, red, parity);
    long long excl =
        threshold_base(ps, sm, th, (uint32_t)budget, warp_tot);
    const int one = single_taker(sm, th);
    if (one >= 0) {
      // the level's only position, and nothing of this thread below it
      const int slot = ps.slot(one);
      const uint32_t take = take_at(ps.key[slot], ps.cap[slot], th,
                                    (uint32_t)budget, excl);
      if (take) {
        commit(nd, first + one, ps, slot, (int)take, dm, sc, single, tb,
               taken, cache);
        sm = summarize(ps, (uint32_t)budget);
      }
    } else if (may_take(sm, th)) {
      bool moved = false;
      for (int q = 0; q < mine; ++q) {
        const int slot = ps.slot(q);
        const uint32_t take = take_at(ps.key[slot], ps.cap[slot], th,
                                      (uint32_t)budget, excl);
        if (take) {
          commit(nd, first + q, ps, slot, (int)take, dm, sc, single, tb,
                 taken, cache);
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

__global__ void __launch_bounds__(kThreads)
tie_perm_kernel(uint32_t seed, int n, int n_pow2, int rounds,
                int* __restrict__ out) {
  extern __shared__ uint64_t keys[];            // n_pow2 words
  int* x = reinterpret_cast<int*>(keys + n_pow2);  // the sequence, n ints

  for (int i = threadIdx.x; i < n; i += blockDim.x) x[i] = i;
  uint32_t k0 = 0u, k1 = seed;  // PRNGKey(seed) of a 32-bit seed
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    // key, subkey = split(key): the counters (0, 0) and (0, 1)
    uint32_t n0 = 0u, n1 = 0u, s0 = 0u, s1 = 1u;
    threefry2x32(k0, k1, n0, n1);
    threefry2x32(k0, k1, s0, s1);
    for (int i = threadIdx.x; i < n_pow2; i += blockDim.x) {
      keys[i] = i < n ? ((uint64_t)threefry_bits(s0, s1, 0u, (uint32_t)i)
                         << 32) | (uint64_t)i
                      : ~0ull;
    }
    __syncthreads();
    bitonic_sort(keys, n_pow2);
    // the values in sorted order, through the keys' low words
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const uint64_t w = keys[j];
      keys[j] = (w & 0xFFFFFFFF00000000ull) | (uint32_t)x[(uint32_t)w];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += blockDim.x) x[j] = (int)(uint32_t)keys[j];
    __syncthreads();
    k0 = n0;
    k1 = n1;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i];
}

}  // namespace

// f32 words of nt_bulk_scan's scratch: n * (2d + 7 + 2s), then, with
// spreads, the cached terms' room
extern "C" long long nt_bulk_scan_scratch_words(int n, int d, int s, int v) {
  const Dims dm{n, d, s, v, 0, 1};
  const size_t cache = s > 0 ? scan_cache_bytes(dm, n) : 0;
  return (long long)n * (2 * d + 7 + 2 * s) + (long long)(cache / 4);
}

// avail (n, d) f32; dyn (n, d + 2) f32: used | placed_tg | placed_job;
// feas (n,) bool; aff (n,) f32; dev (n,) f32 or null (zeros); tie_perm (n,)
// int32; spread_node (2s, n), spread_tab (2s, v), spread_meta (s, 2) f32
// in pack_solve_args' layout (unread when s == 0); scalars (5 + d) f32:
// lowest_boost | tg_count | dh_job | dh_tg | spread_alg | ask[d]; scratch
// nt_bulk_scan_scratch_words(n, d, s, v) f32 words, scratch_words their
// count (a smaller buffer is refused); out (n,) int32.
extern "C" int nt_bulk_scan(const void* avail, const void* dyn,
                            const void* feas, const void* aff, const void* dev,
                            const void* tie_perm, const void* spread_node,
                            const void* spread_tab, const void* spread_meta,
                            const void* scalars, void* scratch, void* out,
                            int n, int d, int s, int v, int k_total, int batch,
                            int n_steps, int scratch_words, void* stream) {
  const Dims dm{n, d, s, v, 0, 1};
  if (n < 1 || n > kMaxNodes || d < 2 || d > kMaxDims || s < 0 ||
      s > kMaxSpreads || v < 1 || batch < 1 || batch > kMaxBatch ||
      n_steps < 0)
    return (int)cudaErrorInvalidValue;
  if (nt_bulk_scan_scratch_words(n, d, s, v) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  const size_t cache = s > 0 ? scan_cache_bytes(dm, n) : 0;
  const size_t work = table_bytes(dm) + scan_work_bytes(n);
  const bool in_smem = work + cache <= kMaxSmem;
  const size_t smem = work + (in_smem ? cache : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = in_smem ? bulk_scan_kernel<true> : bulk_scan_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, scan_threads(n), smem, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)dyn, (const uint8_t*)feas,
      (const float*)aff, (const float*)dev, (const int*)tie_perm,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)scalars, (float*)scratch,
      (int*)out, dm, k_total, batch, n_steps);
  return (int)cudaGetLastError();
}

// out (n,) int32 = jax.random.permutation(PRNGKey(seed), n)
extern "C" int nt_tie_perm(uint32_t seed, int n, int rounds, void* out,
                           void* stream) {
  if (n < 1 || n > kMaxNodes || rounds < 0) return (int)cudaErrorInvalidValue;
  const int n_pow2 = pow2_at_least(n);
  const size_t smem = (size_t)n_pow2 * sizeof(uint64_t) + (size_t)n * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      tie_perm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  tie_perm_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      seed, n, n_pow2, rounds, (int*)out);
  return (int)cudaGetLastError();
}
