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
// took placements. The time goes to what this simple design does instead:
// every active step rescores all N_pad nodes and bitonic-sorts N_pad keys
// on one SM, one step after another. B11' is ~2 x 20 threefry rounds and a
// sort of n keys; its time is the one-CTA sort.
//
// Design: one CTA of 1024 threads runs the whole scan, so the carry chain
// needs only __syncthreads. The CTA gathers every per-node column into
// permuted order in a global scratch buffer (score.cuh's ScratchNodes
// layout, column-major, L2-resident), which also holds the usage and
// placement-count carry and the taken counts; the spread value tables live
// in shared memory beside the sort keys and take their updates by integer
// atomics. Each step packs, per position, desc_key(score) (sort.cuh), the
// position (16 bits) and its cap (16 bits) into one uint64; a bitonic sort
// of the N_pad words in dynamic shared memory (128 KB at 16,384) gives
// the stable order, a block-wide exclusive scan of the caps in that order
// gives each position's take, and the owner of a sorted slot updates its
// node's carry. B11' sorts (draw << 32) | position, which is stable by
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
#include "sort.cuh"
#include "threefry.cuh"

namespace {

using namespace nt_score;
using nt_sort::bitonic_sort;
using nt_sort::block_exclusive_scan;
using nt_sort::desc_key;
using nt_threefry::threefry2x32;
using nt_threefry::threefry_bits;

constexpr int kThreads = 1024;
constexpr int kMaxNodes = 16384;     // position field and shared memory
constexpr int kMaxBatch = 65535;     // cap field
constexpr uint64_t kPadKey = 0xFFFFFFFFFFFF0000ull;  // sorts last, cap 0
constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

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
                 int n_pow2, int k_total, int batch, int n_steps) {
  extern __shared__ uint64_t keys[];  // n_pow2 words, then the tables
  __shared__ int warp_tot[32];
  __shared__ int remaining_sh;
  __shared__ int total_sh;

  const int n = dm.n, d = dm.d, s = dm.s;
  const Tables tb = carve_tables(reinterpret_cast<char*>(keys + n_pow2), dm);
  load_tables(tb, dm, spread_tab, spread_meta, nullptr);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, 0};
  int* taken = nd.i32 + (long long)(2 * d + 6 + 2 * s) * n;

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
  if (threadIdx.x == 0) remaining_sh = k_total;
  __syncthreads();

  const bool single = sc.dh_job || sc.dh_tg || sc.spread_alg;
  const int chunk = n_pow2 >= kThreads ? n_pow2 / kThreads : 1;
  const int lo = threadIdx.x * chunk;
  const bool owns = lo < n_pow2;

  for (int step = 0; step < n_steps; ++step) {
    const int remaining = remaining_sh;
    if (remaining <= 0) break;  // the same value in every thread
    const int budget = remaining < batch ? remaining : batch;
    const float budget_f = (float)budget;
    spread_stats(tb, dm);
    __syncthreads();

    for (int j = threadIdx.x; j < n_pow2; j += blockDim.x) {
      if (j >= n) {
        keys[j] = kPadKey;
        continue;
      }
      const float score = score_node(nd, j, dm, sc, tb, -1, -1.0f);
      float per = INFINITY;
      for (int k = 0; k < d; ++k) {
        if (sc.ask[k] > 0.0f) {
          const float free_k = __fsub_rn(nd.avail(j, k), nd.used(j, k));
          per = fminf(per, floorf(__fdiv_rn(free_k, sc.ask[k])));
        }
      }
      float cap_f = fmaxf(per, 0.0f);
      if (!(score > kNeg)) cap_f = 0.0f;
      if (single) cap_f = fminf(cap_f, 1.0f);
      const int cap = (int)fminf(cap_f, budget_f);
      keys[j] = ((uint64_t)desc_key(score) << 32) | ((uint64_t)j << 16) |
                (uint64_t)cap;
    }
    __syncthreads();
    bitonic_sort(keys, n_pow2);

    int local = 0;
    if (owns) {
      for (int q = lo; q < lo + chunk; ++q) local += (int)(keys[q] & 0xFFFF);
    }
    int excl = block_exclusive_scan(local, warp_tot);
    if (threadIdx.x == blockDim.x - 1) total_sh = excl + local;
    if (owns) {
      for (int q = lo; q < lo + chunk; ++q) {
        const uint64_t w = keys[q];
        const int cap = (int)(w & 0xFFFF);
        int take = budget - excl;
        take = take < 0 ? 0 : (take > cap ? cap : take);
        excl += cap;
        if (take > 0) {
          const int j = (int)((w >> 16) & 0xFFFF);
          const float tf = (float)take;
          for (int k = 0; k < d; ++k) {
            scratch[nd.at(d + k, j)] =
                __fadd_rn(nd.used(j, k), __fmul_rn(sc.ask[k], tf));
          }
          nd.i32[nd.at(2 * d, j)] += take;
          nd.i32[nd.at(2 * d + 1, j)] += take;
          taken[j] += take;
          for (int k = 0; k < s; ++k) {
            if (nd.sok(j, k)) atomicAdd(&tb.scnt[k * dm.v + nd.svid(j, k)], take);
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int placed = total_sh < budget ? total_sh : budget;
      // nothing placed: the carry did not move, so no later step places
      remaining_sh = placed > 0 ? remaining - placed : 0;
    }
    __syncthreads();
  }

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

// avail (n, d) f32; dyn (n, d + 2) f32: used | placed_tg | placed_job;
// feas (n,) bool; aff (n,) f32; dev (n,) f32 or null (zeros); tie_perm (n,)
// int32; spread_node (2s, n), spread_tab (2s, v), spread_meta (s, 2) f32
// in pack_solve_args' layout (unread when s == 0); scalars (5 + d) f32:
// lowest_boost | tg_count | dh_job | dh_tg | spread_alg | ask[d]; scratch
// n * (2d + 7 + 2s) words; out (n,) int32.
extern "C" int nt_bulk_scan(const void* avail, const void* dyn,
                            const void* feas, const void* aff, const void* dev,
                            const void* tie_perm, const void* spread_node,
                            const void* spread_tab, const void* spread_meta,
                            const void* scalars, void* scratch, void* out,
                            int n, int d, int s, int v, int k_total, int batch,
                            int n_steps, void* stream) {
  const Dims dm{n, d, s, v, 0, 1};
  if (n < 1 || n > kMaxNodes || d < 2 || d > kMaxDims || s < 0 ||
      s > kMaxSpreads || v < 1 || batch < 1 || batch > kMaxBatch ||
      n_steps < 0)
    return (int)cudaErrorInvalidValue;
  const int n_pow2 = pow2_at_least(n);
  const size_t smem = (size_t)n_pow2 * sizeof(uint64_t) + table_bytes(dm);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bulk_scan_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)dyn, (const uint8_t*)feas,
      (const float*)aff, (const float*)dev, (const int*)tie_perm,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)scalars, (float*)scratch,
      (int*)out, dm, n_pow2, k_total, batch, n_steps);
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
