// B9 (the K-step scan of solve_task_group_fused) and B10
// (score_nodes_once) as C entry points, both over B8 (score.cuh, shared
// with task_group_shard.cu and bulk_scan.cu).
//
// Replaces: score_nodes (nomad_tpu/tensor/kernels.py:113-249), the scan of
// solve_task_group with its tie_perm gather (kernels.py:267-378) behind the
// packed entry solve_task_group_fused (kernels.py:448-473), and
// score_nodes_once (kernels.py:630-663). The plain torch versions are
// score_nodes_ref / solve_task_group_fused_ref / score_nodes_once_ref in
// tensor/kernels.py; both read the packed f32 layout of pack_solve_args:
//
//   node_mat (N, 2D+6): avail[D] | used[D] | placed_tg | placed_job |
//                       feasible | affinity | dev_affinity | tie_perm
//   step_mat (K, 2): penalty_idx | active
//   spread_node (2S, N): val_id rows, then val_ok rows
//   spread_tab (2S, V): counts rows, then desired rows (NaN = no target)
//   spread_meta (S, 2): has_targets | weight
//   dp_node (2P, N): val_id rows, then val_ok rows
//   dp_tab (P, Vd+1): counts columns | limit column
//   scalars (5+D): lowest_boost | tg_count | dh_job | dh_tg | spread_alg |
//                  ask[D]
//
// One step scores every node with B8 (score.cuh, which states its formula).
// B9 repeats that K times in tie-permuted node space: the first maximal
// permuted position wins, and the carry (usage, placement counts, spread
// and distinct_property value counts, the lowest explicit boost) moves
// only where a node was found and the step is active.
//
// Bound on the H100: neither bytes nor operations. One launch moves
// ~N x 4 x (2D+6+2S+2P) bytes in and 12 K bytes out (under 1 MB at the
// cfg3 width, a fraction of a microsecond of HBM time); the work it needs
// is one full score a node, then per step the S x V and P x Vd value
// tables, the chosen node's rescore and, per node, a lookup per spread
// and property, an add and a division (a few microseconds at the 32-bit
// peak). The time goes to the K steps running one after another, each a
// pass over the nodes, a block-wide argmax and a carry update behind
// barriers.
//
// Design (B9): the cached identity of score.cuh, one CTA of 1024 threads.
// It gathers the columns into permuted order in a global scratch buffer
// (column-major; usage and placement counts are the carry), computes each
// position's cached terms (node_terms: the only powf outside the rescored
// nodes) and keeps those of the live ones, in position order, in shared
// memory (a node that is not ok_local never becomes so again: its usage
// and placements only grow), or in the scratch where they do not fit
// (kShared false: the same algorithm). A live node takes 4 bytes of head,
// 2 of meta, 2 a spread and 2 a property value id, and 4 of position. At
// most one spread and no distinct_property (the spread path's shape) pack
// meta and the value id into one 32-bit word (kLean, lean_score: 0.7 ms of
// 2.6 at cfg3 on the H100 against the general cache's three loads and
// runtime tree).
// The CTA also holds the count tables, the inverse permutation and a tile
// of the next steps' penalty slots. A step: 31 warps make one pass over
// the live slots, cached_score at each (score_node at the penalty slot),
// while the last warp moves the last winner's columns and rescores it; the
// (score desc, position asc) argmax by warp shuffles and one shared-memory
// round; then warp 0 alone updates the count tables and the lowest
// explicit boost and rebuilds the value tables (the whole block where they
// exceed 256 entries). Two __syncthreads a step. (A thread-block cluster
// splitting the positions was measured slower at every size, 2 to 8 CTAs:
// its exchange costs more than the pass it splits.) B10 runs score_node
// over the unpermuted layout, one thread a node.
//
// Arithmetic: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn and accurate powf,
// built with --fmad=false and no fast math, so scores and choices equal
// the plain torch version on the card bit for bit.

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
  if (i < dm.n) out[i] = score_node(nd, i, dm, sc, tb, pen, scalars[0]);
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

// f32 words of the scratch: the N x (2D+6+2S+2P) column words, the inverse
// permutation, the position -> slot map and the region
__host__ __device__ inline long long scratch_need(const Dims& dm) {
  return (long long)dm.n * (2 * dm.d + 8 + 2 * dm.s + 2 * dm.p) +
         (long long)(region_bytes(dm) / 4);
}

template <bool kShared, bool kLean>
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
  char* base = kShared ? smem + (table_bytes(dm) + 15) / 16 * 16
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
    store_terms(j, node_terms(nd, j, dm, sc));
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
      if (!kLean) {
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
        for (int k = 0; k < s; ++k) cache.sv[k * n + at] = ids[k];
        for (int k = 0; k < p; ++k) cache.dv[k * n + at] = ids[s + k];
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
  value_tables(tb, dm, scalars[0], boost, dpok, nullptr);
  __syncthreads();

  for (int step = 0; step < k_steps; ++step) {
    const int tslot = step % (2 * kTile);
    const int pen = tile_pen[tslot];
    const int pslot = tile_slot[tslot];
    const int pending = pending_sh;
    const float lowest = lowest_sh;
    // a live slot's score at this step
    const auto score_at = [&](int l) {
      if (l == pslot) return score_node(nd, pos[l], dm, sc, tb, pen, lowest);
      return kLean ? lean_score(head, word, l, dm, boost)
                   : cached_score(cache, l, dm, boost, dpok);
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
      if (found && lane < s + p) {
        vid = kLean    ? word[best_l] >> 16
              : lane < s ? cache.sv[lane * n + best_l]
                         : cache.dv[(lane - s) * n + best_l];
      }
      float low = INFINITY;
      if (lane < s && vid != kNoValue && tb.has_t[lane] > 0.5f) {
        low = boost[lane * v + vid];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        low = fminf(low, __shfl_xor_sync(0xffffffffu, low, off));
      }
      const float next_low = found ? fminf(lowest, low) : lowest;
      __syncwarp();  // every lane has read the warp arrays
      if (lane < s + p) win_vid[lane] = (uint16_t)vid;
      if (lane == 0) {
        out[step] = (float)best_j;  // a position; mapped at the end
        out[k_steps + step] = found ? 1.0f : 0.0f;
        out[2 * k_steps + step] = best;
        pending_sh = found ? best_l : -1;
        lowest_sh = next_low;
      }
      __syncwarp();
      if (warp_tables && step + 1 < k_steps) {
        warp_value_tables(tb, dm, next_low, boost, dpok, win_vid);
      }
    }
    if (!warp_tables && step + 1 < k_steps) {
      __syncthreads();
      value_tables(tb, dm, lowest_sh, boost, dpok, win_vid);
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

bool dims_ok(const Dims& dm) {
  return dm.n > 0 && dm.d >= 2 && dm.d <= kMaxDims && dm.s >= 0 &&
         dm.s <= kMaxSpreads && dm.p >= 0 && dm.p <= kMaxProps && dm.v > 0 &&
         dm.vd > 0;
}

}  // namespace

extern "C" int nt_score_nodes(const void* node_mat, const void* spread_node,
                              const void* spread_tab, const void* spread_meta,
                              const void* dp_node, const void* dp_tab,
                              const void* scalars, void* out, int pen, int n,
                              int d, int s, int v, int p, int vd,
                              void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm)) return (int)cudaErrorInvalidValue;
  const size_t smem = table_bytes(dm);
  cudaError_t err = set_smem(score_nodes_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + kScoreThreads - 1) / kScoreThreads;
  score_nodes_kernel<<<blocks, kScoreThreads, smem, (cudaStream_t)stream>>>(
      (const float*)node_mat, (const float*)spread_node,
      (const float*)spread_tab, (const float*)spread_meta,
      (const float*)dp_node, (const float*)dp_tab, (const float*)scalars,
      (float*)out, pen, dm);
  return (int)cudaGetLastError();
}

// f32 words of nt_solve_task_group's scratch at these sizes
extern "C" long long nt_solve_task_group_scratch_words(int n, int d, int s,
                                                       int v, int p,
                                                       int vd) {
  return scratch_need(Dims{n, d, s, v, p, vd});
}

// scratch: nt_solve_task_group_scratch_words(n, d, s, v, p, vd) f32 words,
// scratch_words their count (a smaller buffer is refused)
extern "C" int nt_solve_task_group(const void* node_mat, const void* step_mat,
                                   const void* spread_node,
                                   const void* spread_tab,
                                   const void* spread_meta,
                                   const void* dp_node, const void* dp_tab,
                                   const void* scalars, void* scratch,
                                   void* out, int n, int d, int k, int s,
                                   int v, int p, int vd, int scratch_words,
                                   void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  if (scratch_need(dm) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  // the caches in shared memory where they fit; else in the scratch
  const size_t tables = (table_bytes(dm) + 15) / 16 * 16;
  const bool in_smem = tables + region_bytes(dm) <= kMaxSmem;
  const size_t smem = in_smem ? tables + region_bytes(dm) : table_bytes(dm);
  const bool lean = s <= 1 && p == 0;
  auto kernel = in_smem ? (lean ? solve_task_group_kernel<true, true>
                                : solve_task_group_kernel<true, false>)
                        : (lean ? solve_task_group_kernel<false, true>
                                : solve_task_group_kernel<false, false>);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)node_mat, (const float*)step_mat,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)dp_node, (const float*)dp_tab,
      (const float*)scalars, (float*)scratch, (float*)out, k, dm);
  return (int)cudaGetLastError();
}
