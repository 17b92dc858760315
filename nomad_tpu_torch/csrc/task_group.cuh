// B9 and B10's kernels and launches (task_group.cu states what they
// compute and how), shared by task_group.cu (the entry points and the
// narrow instances) and wide/task_group.cu (the wide instances).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "sort.cuh"

namespace {

using namespace nt_score;

constexpr int kThreads = 1024;
constexpr int kScoreThreads = 256;
constexpr int kTile = 256;      // steps whose rows the scan holds at once
constexpr int kPassWarps = 31;  // warps of the pass; the last rescores
// value tables of at most this many entries are rebuilt by warp 0 alone
constexpr int kWarpTable = 256;
// a block's dynamic shared memory, less room for the static arrays
constexpr size_t kMaxSmem = 232448 - 1024;

// Per-node reads of B10: straight from the packed layout, node i.
struct PackedNodes {
  const float* node_mat;
  const float* spread_node;
  const float* dp_node;
  int n, w, d, s, p;
  __device__ float avail(int i, int k) const { return node_mat[(long long)i * w + k]; }
  __device__ float used(int i, int k) const { return node_mat[(long long)i * w + d + k]; }
  __device__ int ptg(int i) const { return (int)node_mat[(long long)i * w + 2 * d]; }
  __device__ int pjob(int i) const { return (int)node_mat[(long long)i * w + 2 * d + 1]; }
  __device__ bool feas(int i) const { return node_mat[(long long)i * w + 2 * d + 2] > 0.5f; }
  __device__ float aff(int i) const { return node_mat[(long long)i * w + 2 * d + 3]; }
  __device__ float dev(int i) const { return node_mat[(long long)i * w + 2 * d + 4]; }
  __device__ int orig(int i) const { return i; }
  __device__ int svid(int i, int k) const { return (int)spread_node[(long long)k * n + i]; }
  __device__ bool sok(int i, int k) const { return spread_node[(long long)(s + k) * n + i] > 0.5f; }
  __device__ int dvid(int i, int k) const { return (int)dp_node[(long long)k * n + i]; }
  __device__ bool dok(int i, int k) const { return dp_node[(long long)(p + k) * n + i] > 0.5f; }
};

// (score desc, position asc): does (s1, j1) beat (s0, j0)?
__device__ __forceinline__ bool better(float s1, int j1, float s0, int j0) {
  return s1 > s0 || (s1 == s0 && j1 < j0);
}

template <bool kWide>
__global__ void __launch_bounds__(kScoreThreads)
score_nodes_kernel(const float* __restrict__ node_mat,
                   const float* __restrict__ spread_node,
                   const float* __restrict__ spread_tab,
                   const float* __restrict__ spread_meta,
                   const float* __restrict__ dp_node,
                   const float* __restrict__ dp_tab,
                   const float* __restrict__ scalars, float* __restrict__ out,
                   int pen, Dims dm) {
  extern __shared__ __align__(16) char smem[];
  const Tables tb = carve_tables(smem, dm);
  load_tables(tb, dm, spread_tab, spread_meta, dp_tab);
  __syncthreads();
  spread_stats(tb, dm);
  __syncthreads();
  const Scalars sc = load_scalars(scalars, dm.d);
  const PackedNodes nd{node_mat, spread_node, dp_node, dm.n, 2 * dm.d + 6,
                       dm.d, dm.s, dm.p};
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < dm.n) {
    out[i] = score_node<kWide>(nd, i, dm, sc, tb, pen, scalars[0]);
  }
}

// Bytes of the scan's region: boost[S x V] f32 | dpok[P x Vd] u8 |
// head[N] f32 | the caches' 16-bit words (meta[N], sv[S x N], dv[P x N];
// or, lean, one 32-bit word a position) | pos[N] i32 | the step tile: pen[2 x kTile], slot[2 x kTile] i32, the
// last winner's slot i32, the lowest boost f32, act[2 x kTile] u8. In
// shared memory after the count tables where it fits (kShared), else in
// the scratch after the inverse permutation (N words) and the position ->
// slot map (N words).
__host__ __device__ inline size_t cache_words(const Dims& dm) {
  const size_t halves = (size_t)dm.n * (1 + dm.s + dm.p);
  return (halves + 1) / 2 > (size_t)dm.n ? (halves + 1) / 2 : (size_t)dm.n;
}
__host__ __device__ inline size_t region_bytes(const Dims& dm) {
  return 4 * (size_t)dm.s * dm.v + 4 * (((size_t)dm.p * dm.vd + 3) / 4) +
         8 * (size_t)dm.n + 4 * cache_words(dm) + 9 * 2 * kTile + 8;
}

// Bytes of the wide instance's winner ids (S + P u16) after the count
// tables, whole 16-byte units; none in the narrow instance
__host__ __device__ inline size_t wide_id_bytes(const Dims& dm) {
  return dims_wide(dm) ? (2 * (size_t)(dm.s + dm.p) + 15) / 16 * 16 : 0;
}

// The block's dynamic shared memory: the count tables, then in the wide
// instance the winner ids, then the region where it fits (in_smem)
__host__ __device__ inline size_t scan_smem(const Dims& dm, bool in_smem) {
  const size_t tables = (table_bytes(dm) + 15) / 16 * 16;
  if (in_smem) return tables + wide_id_bytes(dm) + region_bytes(dm);
  return dims_wide(dm) ? tables + wide_id_bytes(dm) : table_bytes(dm);
}

// f32 words of the scratch: the N x (2D+6+2S+2P) column words, the inverse
// permutation, the position -> slot map and the region
__host__ __device__ inline long long scratch_need(const Dims& dm) {
  return (long long)dm.n * (2 * dm.d + 8 + 2 * dm.s + 2 * dm.p) +
         (long long)(region_bytes(dm) / 4);
}

// the compaction's value ids held a thread at a time (wide instance)
constexpr int kIdGroup = kMaxSpreads + kMaxProps;

template <bool kShared, bool kLean, bool kWide>
__global__ void __launch_bounds__(kThreads)
solve_task_group_kernel(const float* __restrict__ node_mat,
                        const float* __restrict__ step_mat,
                        const float* __restrict__ spread_node,
                        const float* __restrict__ spread_tab,
                        const float* __restrict__ spread_meta,
                        const float* __restrict__ dp_node,
                        const float* __restrict__ dp_tab,
                        const float* __restrict__ scalars,
                        float* __restrict__ scratch, float* __restrict__ out,
                        int k_steps, Dims dm) {
  extern __shared__ __align__(16) char smem[];
  // the warps' best (score, slot); once warp 0 has read them, the step's
  // winner: its value ids
  __shared__ float warp_score[32];
  __shared__ int warp_pos[32];
  uint16_t* const win_vid = reinterpret_cast<uint16_t*>(warp_score);
  const size_t tables16 = (table_bytes(dm) + 15) / 16 * 16;
  // the wide instance's winner ids (S + P), after the count tables
  uint16_t* const win_ids =
      kWide ? reinterpret_cast<uint16_t*>(smem + tables16) : win_vid;

  const int n = dm.n, d = dm.d, s = dm.s, p = dm.p, v = dm.v;
  const int w = 2 * d + 6;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool warp_tables = s * v + p * dm.vd <= kWarpTable;

  const Tables tb = carve_tables(smem, dm);
  load_tables(tb, dm, spread_tab, spread_meta, dp_tab);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, p};

  int* inv = reinterpret_cast<int*>(scratch) +
            (long long)n * (w + 2 * s + 2 * p);
  int* slot_of = inv + n;
  char* base = kShared ? smem + tables16 + (kWide ? wide_id_bytes(dm) : 0)
                       : reinterpret_cast<char*>(slot_of + n);
  float* boost = reinterpret_cast<float*>(base);
  uint8_t* dpok = reinterpret_cast<uint8_t*>(boost + s * v);
  float* head = reinterpret_cast<float*>(dpok + 4 * ((p * dm.vd + 3) / 4));
  uint16_t* meta = reinterpret_cast<uint16_t*>(head + n);
  uint32_t* word = reinterpret_cast<uint32_t*>(meta);  // lean
  const NodeCache cache{head, meta, meta + n, meta + n * (1 + s), n};
  int* pos = reinterpret_cast<int*>(word + cache_words(dm));
  int* tile_pen = pos + n;
  int* tile_slot = tile_pen + 2 * kTile;
  // the last winner's slot (-1 where none), the lowest boost
  int& pending_sh = tile_slot[2 * kTile];
  float& lowest_sh = reinterpret_cast<float*>(tile_slot)[2 * kTile + 1];
  uint8_t* tile_act = reinterpret_cast<uint8_t*>(tile_slot + 2 * kTile + 2);

  // a position's cached terms into entry c (the lean word keeps its id)
  const auto store_terms = [&](int c, const NodeTerms& t) {
    head[c] = t.head;
    if (kLean) {
      word[c] = (word[c] & 0xffff0000u) | t.meta;
    } else {
      meta[c] = t.meta;
    }
  };

  // gather the positions into permuted (tie_perm) order, with their
  // cached terms at entry j
  for (int j = tid; j < n; j += kThreads) {
    const int i = (int)node_mat[(long long)j * w + 2 * d + 5];
    const float* row = node_mat + (long long)i * w;
    for (int k = 0; k < 2 * d; ++k) scratch[nd.at(k, j)] = row[k];
    nd.i32[nd.at(2 * d, j)] = (int)row[2 * d];
    nd.i32[nd.at(2 * d + 1, j)] = (int)row[2 * d + 1];
    scratch[nd.at(2 * d + 2, j)] = row[2 * d + 2];
    scratch[nd.at(2 * d + 3, j)] = row[2 * d + 3];
    scratch[nd.at(2 * d + 4, j)] = row[2 * d + 4];
    nd.i32[nd.at(2 * d + 5, j)] = i;
    inv[i] = j;
    if (kLean) word[j] = (uint32_t)kNoValue << 16;
    for (int k = 0; k < s; ++k) {
      const int vid = (int)spread_node[(long long)k * n + i];
      const float ok = spread_node[(long long)(s + k) * n + i];
      nd.i32[nd.at(2 * d + 6 + k, j)] = vid;
      scratch[nd.at(2 * d + 6 + s + k, j)] = ok;
      const uint16_t id = ok > 0.5f ? (uint16_t)vid : kNoValue;
      if (kLean) {
        word[j] = (uint32_t)id << 16;
      } else {
        cache.sv[k * n + j] = id;
      }
    }
    for (int k = 0; k < p; ++k) {
      const int vid = (int)dp_node[(long long)k * n + i];
      const float ok = dp_node[(long long)(p + k) * n + i];
      nd.i32[nd.at(2 * d + 6 + 2 * s + k, j)] = vid;
      scratch[nd.at(2 * d + 6 + 2 * s + p + k, j)] = ok;
      cache.dv[k * n + j] = ok > 0.5f ? (uint16_t)vid : kNoValue;
    }
    store_terms(j, node_terms<kWide>(nd, j, dm, sc));
  }
  __syncthreads();
  // keep only the live entries (ok_local: a node that is not never
  // becomes so again, as its usage and placements only grow), in position
  // order: entry j moves to slot live, pos[live] = j
  int live = 0;
  for (int first = 0; first < n; first += kThreads) {
    const int j = first + tid;
    bool ok = false;
    float h = 0.0f;
    uint32_t wd = 0u;
    uint16_t ids[kMaxSpreads + kMaxProps];
    if (j < n) {
      h = head[j];
      wd = kLean ? word[j] : meta[j];
      ok = (wd & kOkLocal) != 0;
      if (!kLean && !kWide) {
        for (int k = 0; k < s; ++k) ids[k] = cache.sv[k * n + j];
        for (int k = 0; k < p; ++k) ids[s + k] = cache.dv[k * n + j];
      }
    }
    const int at = live + nt_sort::block_exclusive_scan(
                              ok ? 1 : 0, reinterpret_cast<int*>(warp_pos));
    if (j < n) slot_of[j] = ok ? at : -1;
    if (ok) {
      head[at] = h;
      pos[at] = j;
      if (kLean) {
        word[at] = wd;
      } else {
        meta[at] = (uint16_t)wd;
        if (!kWide) {
          for (int k = 0; k < s; ++k) cache.sv[k * n + at] = ids[k];
          for (int k = 0; k < p; ++k) cache.dv[k * n + at] = ids[s + k];
        }
      }
    }
    if (kWide && !kLean) {
      // the S + P id rows (dv follows sv), kIdGroup rows at a time: every
      // thread reads its group before any thread writes it
      for (int g = 0; g < s + p; g += kIdGroup) {
        const int m = min(kIdGroup, s + p - g);
        if (ok) {
          for (int q = 0; q < m; ++q) ids[q] = cache.sv[(g + q) * n + j];
        }
        __syncthreads();
        if (ok) {
          for (int q = 0; q < m; ++q) cache.sv[(g + q) * n + at] = ids[q];
        }
        __syncthreads();
      }
    }
    live += __syncthreads_count(ok);
  }
  if (tid == 0) {
    pending_sh = -1;
    lowest_sh = scalars[0];
  }
  // the rows of steps first .. first + kTile - 1: penalty, its live slot
  // (-1 where none: a dead penalty node scores NEG anyway), active
  const auto load_tile = [&](int first) {
    const int last = min(k_steps, first + kTile);
    for (int t = first + tid; t < last; t += kThreads) {
      const int pen = (int)step_mat[2 * t];
      tile_pen[t % (2 * kTile)] = pen;
      tile_slot[t % (2 * kTile)] =
          pen >= 0 && pen < n ? slot_of[inv[pen]] : -1;
      tile_act[t % (2 * kTile)] = step_mat[2 * t + 1] > 0.5f ? 1 : 0;
    }
  };
  __syncthreads();  // slot_of
  load_tile(0);
  value_tables<kWide>(tb, dm, scalars[0], boost, dpok, nullptr);
  __syncthreads();

  for (int step = 0; step < k_steps; ++step) {
    const int tslot = step % (2 * kTile);
    const int pen = tile_pen[tslot];
    const int pslot = tile_slot[tslot];
    const int pending = pending_sh;
    const float lowest = lowest_sh;
    // a live slot's score at this step
    const auto score_at = [&](int l) {
      if (l == pslot) {
        return score_node<kWide>(nd, pos[l], dm, sc, tb, pen, lowest);
      }
      return kLean ? lean_score(head, word, l, dm, boost)
                   : cached_score<kWide>(cache, l, dm, boost, dpok);
    };
    float best = -INFINITY;
    int best_l = 0x7fffffff;
    if (warp < kPassWarps) {
      // the pass: every live slot but the last winner's
      for (int l = tid; l < live; l += kPassWarps * 32) {
        if (l == pending) continue;
        const float sc_l = score_at(l);
        if (sc_l > best) {
          best = sc_l;
          best_l = l;
        }
      }
    } else if (pending >= 0 && lane == 0) {
      // meanwhile the last winner's columns move and it is rescored
      const int j = pos[pending];
      if constexpr (kWide) {
        // the columns move in the scratch, then are read back
        for (int k = 0; k < d; ++k) {
          scratch[nd.at(d + k, j)] = __fadd_rn(nd.used(j, k), sc.askp[k]);
        }
        nd.i32[nd.at(2 * d, j)] += 1;
        nd.i32[nd.at(2 * d + 1, j)] += 1;
        store_terms(pending, node_terms<true>(nd, j, dm, sc));
      } else {
        NodeRow row = load_row(nd, j, d);
#pragma unroll
        for (int k = 0; k < kMaxDims; ++k) {
          if (k < d) {
            row.us[k] = __fadd_rn(row.us[k], sc.ask[k]);
            scratch[nd.at(d + k, j)] = row.us[k];
          }
        }
        row.ptg_ += 1;
        row.pjob_ += 1;
        nd.i32[nd.at(2 * d, j)] = row.ptg_;
        nd.i32[nd.at(2 * d + 1, j)] = row.pjob_;
        store_terms(pending, node_terms(row, 0, dm, sc));
      }
      best = score_at(pending);
      best_l = pending;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best, off);
      const int ol = __shfl_down_sync(0xffffffffu, best_l, off);
      if (better(os, ol, best, best_l)) {
        best = os;
        best_l = ol;
      }
    }
    if (lane == 0) {
      warp_score[warp] = best;
      warp_pos[warp] = best_l;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_score[lane];
      best_l = warp_pos[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, best, off);
        const int ol = __shfl_xor_sync(0xffffffffu, best_l, off);
        if (better(os, ol, best, best_l)) {
          best = os;
          best_l = ol;
        }
      }
      // positions order as slots do; where no live position scores above
      // NEG the reference's argmax is position 0, at NEG
      const bool any = best > kNeg;
      const int best_j = any ? pos[best_l] : 0;
      if (!any) best = kNeg;
      // the winner: its value ids, the lowest of its explicit boosts from
      // this step's table; then the carry of everything but its columns
      // (the next pass moves those)
      const bool found = tile_act[tslot] && any;
      if (found && lane < 2 * d + 5) {
        // the next pass's rescore reads columns 0 .. 2D+4: into L1 now
        asm volatile("prefetch.global.L1 [%0];" ::"l"(
            scratch + nd.at(lane, best_j)));
      }
      unsigned vid = kNoValue;
      float low = INFINITY;
      if constexpr (kWide) {
        // id k by lane k % 32, into win_ids (not the warp arrays)
        for (int k = lane; k < s + p; k += 32) {
          unsigned id = kNoValue;
          if (found) id = kLean ? word[best_l] >> 16 : cache.sv[k * n + best_l];
          if (k < s && id != kNoValue && tb.has_t[k] > 0.5f) {
            low = fminf(low, boost[k * v + id]);
          }
          win_ids[k] = (uint16_t)id;
        }
      } else {
        if (found && lane < s + p) {
          vid = kLean    ? word[best_l] >> 16
                : lane < s ? cache.sv[lane * n + best_l]
                           : cache.dv[(lane - s) * n + best_l];
        }
        if (lane < s && vid != kNoValue && tb.has_t[lane] > 0.5f) {
          low = boost[lane * v + vid];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        low = fminf(low, __shfl_xor_sync(0xffffffffu, low, off));
      }
      const float next_low = found ? fminf(lowest, low) : lowest;
      __syncwarp();  // every lane has read the warp arrays
      if (!kWide && lane < s + p) win_vid[lane] = (uint16_t)vid;
      if (lane == 0) {
        out[step] = (float)best_j;  // a position; mapped at the end
        out[k_steps + step] = found ? 1.0f : 0.0f;
        out[2 * k_steps + step] = best;
        pending_sh = found ? best_l : -1;
        lowest_sh = next_low;
      }
      __syncwarp();
      if (warp_tables && step + 1 < k_steps) {
        warp_value_tables(tb, dm, next_low, boost, dpok, win_ids);
      }
    }
    if (!warp_tables && step + 1 < k_steps) {
      __syncthreads();
      value_tables<kWide>(tb, dm, lowest_sh, boost, dpok, win_ids);
    }
    if ((step + 1) % kTile == 0 && step + 1 < k_steps) load_tile(step + 1);
    __syncthreads();
  }
  // the chosen positions mapped back to their nodes
  for (int t = tid; t < k_steps; t += kThreads) {
    const int j = (int)out[t];
    out[t] = node_mat[(long long)j * w + 2 * d + 5];
  }
}

template <class Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// every shape the reference takes; the callers check the shared-memory
// limit
bool dims_ok(const Dims& dm) {
  return dm.n > 0 && dm.d >= 2 && dm.s >= 0 && dm.p >= 0 && dm.v > 0 &&
         dm.vd > 0;
}


// The launches of one instance (kWide: score.cuh's wide instance), the
// shape checked by task_group.cu's entry points
template <bool kWide>
cudaError_t launch_score_nodes(const void* node_mat, const void* spread_node,
                               const void* spread_tab,
                               const void* spread_meta, const void* dp_node,
                               const void* dp_tab, const void* scalars,
                               void* out, int pen, const Dims& dm,
                               cudaStream_t stream) {
  const size_t smem = table_bytes(dm);
  cudaError_t err = set_smem(score_nodes_kernel<kWide>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (dm.n + kScoreThreads - 1) / kScoreThreads;
  score_nodes_kernel<kWide><<<blocks, kScoreThreads, smem, stream>>>(
      (const float*)node_mat, (const float*)spread_node,
      (const float*)spread_tab, (const float*)spread_meta,
      (const float*)dp_node, (const float*)dp_tab, (const float*)scalars,
      (float*)out, pen, dm);
  return cudaGetLastError();
}

template <bool kWide>
cudaError_t launch_solve_task_group(
    const void* node_mat, const void* step_mat, const void* spread_node,
    const void* spread_tab, const void* spread_meta, const void* dp_node,
    const void* dp_tab, const void* scalars, void* scratch, void* out, int k,
    const Dims& dm, cudaStream_t stream) {
  // the caches in shared memory where they fit; else in the scratch
  const bool in_smem = scan_smem(dm, true) <= kMaxSmem;
  const size_t smem = scan_smem(dm, in_smem);
  const bool lean = dm.s <= 1 && dm.p == 0;
  auto kernel = in_smem ? (lean ? solve_task_group_kernel<true, true, kWide>
                                : solve_task_group_kernel<true, false, kWide>)
                        : (lean ? solve_task_group_kernel<false, true, kWide>
                                : solve_task_group_kernel<false, false, kWide>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kThreads, smem, stream>>>(
      (const float*)node_mat, (const float*)step_mat,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)dp_node, (const float*)dp_tab,
      (const float*)scalars, (float*)scratch, (float*)out, k, dm);
  return cudaGetLastError();
}

}  // namespace

namespace nt_task_group {

// The wide instances' launches, in wide/task_group.cu: a translation unit
// of its own, which nvcc compiles beside this library's and the linker
// puts into the same library
cudaError_t score_nodes_wide(const void* node_mat, const void* spread_node,
                             const void* spread_tab, const void* spread_meta,
                             const void* dp_node, const void* dp_tab,
                             const void* scalars, void* out, int pen,
                             const Dims& dm, cudaStream_t stream);
cudaError_t solve_task_group_wide(
    const void* node_mat, const void* step_mat, const void* spread_node,
    const void* spread_tab, const void* spread_meta, const void* dp_node,
    const void* dp_tab, const void* scalars, void* scratch, void* out, int k,
    const Dims& dm, cudaStream_t stream);

}  // namespace nt_task_group
