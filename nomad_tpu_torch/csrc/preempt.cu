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
// only the chosen node's carry changes in a step, one score a node and
// then one rescore a step. The K steps run one after another (each reads
// the carry the previous one wrote), so the time is the set-up pass plus
// K times one step's latency on one SM.
//
// Design of nt_preempt_solve (B7): one CTA of 1,024 threads. The set-up
// pass, all threads: the carry copied (used, ev = sum of the eligible
// victim vectors), a claimed-prefix pointer a node zeroed, the victims
// output zeroed, every node scored once, and its order key, desc_key(score)
// << 32 | index (sort.cuh), stored; the minimum key is jnp.argmax's first
// maximum. The keys are reduced into a two-level tree: the minimum of each
// 32-node segment, then one warp's minimum over the segments. The keys
// and the segment minima live in shared memory (the keys in the global
// scratch where they do not fit). Then warp 0 alone runs the K steps, with
// no block barrier: it reads the top of the tree; stops at the first
// step whose best score is NEG (no carry can change again, so every later
// step writes -1, NEG and no victims); skips an inactive step (nothing
// changes); else forms the chosen node's deficit, scans its unclaimed
// eligible columns 32 at a time with warp shuffles (a prefix sum a dim)
// until the prefix covers the deficit, writes the victims, the pick, the
// flag and the score, commits that node's carry row, rescores it and
// refreshes its segment and the top.
//
// The claimed-prefix pointer: the victims of a step are a prefix of the
// chosen node's unclaimed eligible columns (cum_before never decreases
// for nonnegative vectors), so the claimed columns of a node are always
// all its eligible columns below one index, ptr[node]. The (N, V) taken
// bits of the reference are that pointer.
//
// Exactness: resource values are integral f32 below 2^24, so every sum over
// victims (ev, the prefix sums, evicted) is exact in any order; the scores
// use correctly rounded arithmetic and accurate powf / expf (fit.cuh, built
// with --fmad=false), and a node's cached key is recomputed from its carry
// whenever the carry changes. Picks, victims, flags and scores equal the
// plain torch version (tensor/kernels.py preempt_solve_ref) exactly.
//
// Design of nt_preempt_pick (B12, on no path): B7's without victims. The
// set-up pass, all threads: the carry copied (used, evictable), every node
// scored once and its order key cached in the same two-level tree (keys in
// shared memory up to ~28,000 nodes, in the scratch above). Then warp 0
// alone runs the K steps: it stops at the first step whose best score is
// NEG (every later step writes -1), writes -1 for an inactive step, else
// commits the chosen node's row (used = min(used + ask, avail), evictable
// = max(evictable - deficit, 0)), rescores it once and refreshes its
// segment and the top. The key cache and the tree are B7's helpers below
// (cache_keys, tree_top, segment_peers, refresh_top).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"
#include "sort.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDims = 8;
constexpr float kNeg = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // a block's shared memory
constexpr uint64_t kNoKey = ~0ull;

using nt_fit::fit_score;
using nt_fit::preempt_score;
using nt_sort::desc_key;

// One node's preemption score for the next placement, and its deficit, over
// d <= kDims resource columns.
template <int kDims>
__device__ __forceinline__ float node_score(const float* avail,
                                            const float* used,
                                            const float* ask, const float* ev,
                                            bool feasible, float pscore, int d,
                                            float* deficit, bool* needs_out) {
  float clamped[kDims];
  bool can = feasible;
  bool needs = false;
#pragma unroll
  for (int k = 0; k < kDims; ++k) {
    if (k < d) {
      const float nu = __fadd_rn(used[k], ask[k]);
      deficit[k] = fmaxf(__fsub_rn(nu, avail[k]), 0.0f);
      can = can && deficit[k] <= ev[k];
      needs = needs || deficit[k] > 0.0f;
      clamped[k] = fminf(nu, avail[k]);
    }
  }
  *needs_out = needs;
  const float score = __fdiv_rn(
      __fadd_rn(fit_score(avail, clamped), needs ? pscore : 0.0f),
      needs ? 2.0f : 1.0f);
  return can ? score : kNeg;
}

// The order key of (score desc, index asc): the smallest key is the first
// maximum of the scores, as jnp.argmax takes it.
__device__ __forceinline__ uint64_t order_key(float score, int i) {
  return ((uint64_t)desc_key(score) << 32) | (uint32_t)i;
}

// The score a key holds (desc_key inverted; -0.0 comes back as +0.0,
// which equals it).
__device__ __forceinline__ float key_score(uint64_t key) {
  const uint32_t ord = ~(uint32_t)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ uint64_t warp_min(uint64_t x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t y = __shfl_xor_sync(kFull, x, off);
    x = y < x ? y : x;
  }
  return x;
}


// B7's and B12's tree: one minimum key a 32-node segment
__host__ __device__ inline int segments(int n) { return (n + 31) / 32; }

// Every thread: each node's order key cached from its carry, then one warp
// a segment's minimum. The carry must be visible to the whole block.
template <int D>
__device__ __forceinline__ void cache_keys(const float* __restrict__ avail,
                           const float* used, const float* ask,
                           const float* ev,
                           const uint8_t* __restrict__ feasible,
                           const float* __restrict__ net_prio,
                           uint64_t* keys, uint64_t* seg, int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float def[D];
    bool needs;
    const float s = node_score<D>(avail + (long long)i * D,
                                  used + (long long)i * D, ask,
                                  ev + (long long)i * D, feasible[i] != 0,
                                  preempt_score(net_prio[i]), D, def, &needs);
    keys[i] = order_key(s, i);
  }
  __syncthreads();
  for (int s = warp; s < segments(n); s += kWarps) {
    const int i = s * 32 + lane;
    const uint64_t m = warp_min(i < n ? keys[i] : kNoKey);
    if (lane == 0) seg[s] = m;
  }
  __syncthreads();
}

// Warp 0: the tree's top, the minimum over the segments
__device__ __forceinline__ uint64_t tree_top(const uint64_t* seg, int segs) {
  uint64_t top = kNoKey;
  for (int s = threadIdx.x & 31; s < segs; s += 32) {
    top = seg[s] < top ? seg[s] : top;
  }
  return warp_min(top);
}

// Warp 0: the keys of node b's segment but b's own (kNoKey there and past
// n), read ahead of b's rescore
__device__ __forceinline__ uint64_t segment_peers(const uint64_t* keys,
                                                  int n, int b) {
  const int i = ((b >> 5) << 5) + (threadIdx.x & 31);
  return i < n && i != b ? keys[i] : kNoKey;
}

// Warp 0, once node b's carry moved: its new key nk stored, its segment's
// minimum refreshed from the peers read before; returns the new top
__device__ __forceinline__ uint64_t refresh_top(uint64_t* keys, uint64_t* seg,
                                                int segs, int b,
                                                uint64_t peer, uint64_t nk) {
  const int lane = threadIdx.x & 31;
  const int sb = b >> 5;
  const bool mine = (sb << 5) + lane == b;
  const uint64_t m = warp_min(mine ? nk : peer);
  if (mine) keys[b] = nk;
  uint64_t top = kNoKey;
  for (int s = lane; s < segs; s += 32) {
    const uint64_t t = s == sb ? m : seg[s];
    top = t < top ? t : top;
  }
  top = warp_min(top);
  if (lane == 0) seg[sb] = m;
  __syncwarp();
  return top;
}

// Whether the keys and the claimed-prefix pointers fit in shared memory
// beside the segment minima (else they live in the scratch)
inline bool solve_in_smem(int n) {
  return (size_t)(n + segments(n)) * sizeof(uint64_t) +
             (size_t)n * sizeof(int) <=
         kMaxSmem;
}

// B7's scratch, in 4-byte words: used and ev (n x d f32 each), then, when
// they are not in shared memory, the pointers (n int32) and, 8-byte
// aligned, the keys (n uint64)
__host__ __device__ inline long long key_offset(int n, int d) {
  return ((long long)n * (2 * d + 1) + 1) / 2 * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
preempt_solve_kernel(const float* __restrict__ avail,
                     const float* __restrict__ used0,
                     const float* __restrict__ ask_g,
                     const uint8_t* __restrict__ feasible,
                     const float* __restrict__ net_prio,
                     const uint8_t* __restrict__ active,
                     const float* __restrict__ v_vec,
                     const uint8_t* __restrict__ v_elig,
                     const uint8_t* __restrict__ v_flag, float* scratch,
                     bool in_smem, int* __restrict__ picks,
                     uint8_t* __restrict__ victims,
                     uint8_t* __restrict__ flagged,
                     float* __restrict__ scores, int n, int v,
                     int k_steps) {
  extern __shared__ uint64_t sh[];
  const int segs = segments(n);
  uint64_t* seg = sh;
  float* used = scratch;                      // (N, D) carry
  float* ev = scratch + (long long)n * D;     // (N, D) evictable carry
  uint64_t* keys;
  int* ptr;
  if (in_smem) {
    keys = sh + segs;
    ptr = reinterpret_cast<int*>(keys + n);
  } else {
    ptr = reinterpret_cast<int*>(ev + (long long)n * D);
    keys = reinterpret_cast<uint64_t*>(scratch + key_offset(n, D));
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float ask[D];
#pragma unroll
  for (int k = 0; k < D; ++k) ask[k] = ask_g[k];

  // ---- set-up pass, every thread ----
  for (long long j = threadIdx.x; j < (long long)n * D; j += kThreads) {
    used[j] = used0[j];
  }
  for (int i = threadIdx.x; i < n; i += kThreads) ptr[i] = 0;
  {
    // the victims output, zeroed once: a step writes only its selection
    const long long bytes = (long long)k_steps * v;
    uint4* wide = reinterpret_cast<uint4*>(victims);
    for (long long j = threadIdx.x; j < bytes / 16; j += kThreads) {
      wide[j] = make_uint4(0u, 0u, 0u, 0u);
    }
    for (long long j = bytes / 16 * 16 + threadIdx.x; j < bytes;
         j += kThreads) {
      victims[j] = 0;
    }
  }
  // ev0 = sum_v v_vec * v_elig: `group` lanes a node (one a node up to 16
  // columns, up to a warp at 512), each over runs of 16 columns whose
  // eligibility bytes it loads together
  int group = 1;
  while (group < 32 && group * 16 < v) group <<= 1;
  const int per_warp = 32 / group;
  for (int base = warp * per_warp; base < n; base += kWarps * per_warp) {
    const int i = base + lane / group;
    float acc[D];
#pragma unroll
    for (int k = 0; k < D; ++k) acc[k] = 0.0f;
    if (i < n) {
      const uint8_t* erow = v_elig + (long long)i * v;
      for (int c0 = lane % group * 16; c0 < v; c0 += group * 16) {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (c0 + q < v && erow[c0 + q]) {
            const float* vec = v_vec + ((long long)i * v + c0 + q) * D;
#pragma unroll
            for (int k = 0; k < D; ++k) acc[k] = __fadd_rn(acc[k], vec[k]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      for (int off = group >> 1; off > 0; off >>= 1) {
        acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(kFull, acc[k], off));
      }
      if (i < n && lane % group == 0) ev[(long long)i * D + k] = acc[k];
    }
  }
  __syncthreads();
  // every node scored once; its key cached
  cache_keys<D>(avail, used, ask, ev, feasible, net_prio, keys, seg, n);
  if (warp != 0) return;

  // ---- the K steps, warp 0 alone ----
  uint64_t top = tree_top(seg, segs);
  bool act = k_steps > 0 && active[0];
  for (int step = 0; step < k_steps; ++step) {
    const bool act_next = step + 1 < k_steps && active[step + 1];  // ahead
    const float best_s = key_score(top);
    if (!(best_s > kNeg)) {
      // no node can take a request, and no carry changes again
      for (int t = step + lane; t < k_steps; t += 32) {
        picks[t] = -1;
        flagged[t] = 0;
        scores[t] = kNeg;
      }
      return;
    }
    if (!act) {  // changes nothing
      if (lane == 0) {
        picks[step] = -1;
        flagged[step] = 0;
        scores[step] = kNeg;
      }
      act = act_next;
      continue;
    }
    act = act_next;
    const int b = (int)(uint32_t)top;
    const float* a = avail + (long long)b * D;
    float* u = used + (long long)b * D;
    float* e = ev + (long long)b * D;
    // the chosen node's row, and its first 32 columns from its pointer
    // (loaded beside the row, before the deficit says whether it evicts)
    const int p0 = ptr[b];
    int c = p0 + lane;
    long long col = (long long)b * v + c;
    bool in = c < v;
    bool elig = in && v_elig[col];
    bool fl = in && v_flag[col];
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = in ? v_vec[col * D + k] : 0.0f;
    const float pscore = preempt_score(net_prio[b]);
    float ub[D], eb[D], def[D], evicted[D];
    bool needs = false;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      ub[k] = u[k];
      eb[k] = e[k];
      def[k] = fmaxf(__fsub_rn(__fadd_rn(ub[k], ask[k]), a[k]), 0.0f);
      needs = needs || def[k] > 0.0f;
      evicted[k] = 0.0f;
    }
    bool flag = false;
    if (needs) {
      // the unclaimed eligible columns from the pointer on, 32 at a time:
      // a column is taken while its exclusive prefix is below the deficit
      // in some dim with a deficit
      uint8_t* vrow = victims + (long long)step * v;
      float carry[D];
#pragma unroll
      for (int k = 0; k < D; ++k) carry[k] = 0.0f;
      int last = -1;
      for (int base = p0;;) {
        float x[D], incl[D];
#pragma unroll
        for (int k = 0; k < D; ++k) {
          x[k] = elig ? xv[k] : 0.0f;
          incl[k] = x[k];
        }
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float y = __shfl_up_sync(kFull, incl[k], off);
            if (lane >= off) incl[k] = __fadd_rn(incl[k], y);
          }
        }
        bool sel = false;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float before = __fadd_rn(carry[k], __fsub_rn(incl[k], x[k]));
          sel = sel || (def[k] > 0.0f && before < def[k]);
        }
        sel = sel && elig;
        if (sel) {
          vrow[c] = 1;
          flag = flag || fl;
        }
        const unsigned took = __ballot_sync(kFull, sel);
        if (took) {
          // the selection is a prefix of the eligible columns (the others
          // add 0): its sum is the prefix at its last lane
          const int top = 31 - __clz(took);
          last = base + top;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            evicted[k] = __fadd_rn(carry[k], __shfl_sync(kFull, incl[k], top));
          }
        }
        bool covered = true;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          carry[k] = __fadd_rn(carry[k], __shfl_sync(kFull, incl[k], 31));
          covered = covered && !(def[k] > 0.0f && carry[k] < def[k]);
        }
        // nothing after an unselected column, or past a covered prefix,
        // is taken (the prefix never decreases)
        base += 32;
        if (covered || base >= v || __any_sync(kFull, elig && !sel)) break;
        c = base + lane;
        col = (long long)b * v + c;
        in = c < v;
        elig = in && v_elig[col];
        fl = in && v_flag[col];
#pragma unroll
        for (int k = 0; k < D; ++k) xv[k] = in ? v_vec[col * D + k] : 0.0f;
      }
      flag = __any_sync(kFull, flag);
      if (lane == 0 && last >= 0) ptr[b] = last + 1;
    }
    // commit the chosen node's carry row, then rescore it
    float nu[D], ne[D], nd[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      nu[k] = fmaxf(__fsub_rn(__fadd_rn(ub[k], ask[k]), evicted[k]), 0.0f);
      ne[k] = fmaxf(__fsub_rn(eb[k], evicted[k]), 0.0f);
    }
    if (lane == 0) {
      picks[step] = b;
      flagged[step] = flag;
      scores[step] = best_s;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        u[k] = nu[k];
        e[k] = ne[k];
      }
    }
    // b's segment, read while the rescore runs
    const uint64_t peer = segment_peers(keys, n, b);
    bool nneeds;
    const uint64_t nk = order_key(
        node_score<D>(a, nu, ask, ne, true, pscore, D, nd, &nneeds), b);
    top = refresh_top(keys, seg, segs, b, peer, nk);
  }
}

// Whether B12's keys fit in shared memory beside the segment minima (else
// they live in the scratch)
inline bool pick_in_smem(int n) {
  return (size_t)(n + segments(n)) * sizeof(uint64_t) <= kMaxSmem;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
preempt_pick_kernel(const float* __restrict__ avail,
                    const float* __restrict__ used0,
                    const float* __restrict__ evictable0,
                    const float* __restrict__ ask_g,
                    const uint8_t* __restrict__ feasible,
                    const float* __restrict__ net_prio,
                    const uint8_t* __restrict__ active, float* scratch,
                    bool in_smem, int* __restrict__ picks, int n,
                    int k_steps) {
  extern __shared__ uint64_t sh[];
  const int segs = segments(n);
  uint64_t* seg = sh;
  float* used = scratch;                      // (N, D) carry
  float* ev = scratch + (long long)n * D;     // (N, D) evictable carry
  uint64_t* keys = in_smem ? sh + segs
                           : reinterpret_cast<uint64_t*>(
                                 scratch + 2LL * n * D);
  const int lane = threadIdx.x & 31;
  float ask[D];
#pragma unroll
  for (int k = 0; k < D; ++k) ask[k] = ask_g[k];

  // ---- set-up pass, every thread ----
  for (long long j = threadIdx.x; j < (long long)n * D; j += kThreads) {
    used[j] = used0[j];
    ev[j] = evictable0[j];
  }
  __syncthreads();
  cache_keys<D>(avail, used, ask, ev, feasible, net_prio, keys, seg, n);
  if (threadIdx.x >= 32) return;

  // ---- the K steps, warp 0 alone ----
  uint64_t top = tree_top(seg, segs);
  bool act = k_steps > 0 && active[0];
  for (int step = 0; step < k_steps; ++step) {
    const bool act_next = step + 1 < k_steps && active[step + 1];  // ahead
    if (!(key_score(top) > kNeg)) {
      // no node can take a request, and no carry changes again
      for (int t = step + lane; t < k_steps; t += 32) picks[t] = -1;
      return;
    }
    if (!act) {  // changes nothing
      if (lane == 0) picks[step] = -1;
      act = act_next;
      continue;
    }
    act = act_next;
    const int b = (int)(uint32_t)top;
    const uint64_t peer = segment_peers(keys, n, b);
    const float* a = avail + (long long)b * D;
    float* u = used + (long long)b * D;
    float* e = ev + (long long)b * D;
    const float pscore = preempt_score(net_prio[b]);
    float nu[D], ne[D], nd[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float want = __fadd_rn(u[k], ask[k]);
      const float deficit = fmaxf(__fsub_rn(want, a[k]), 0.0f);
      nu[k] = fminf(want, a[k]);
      ne[k] = fmaxf(__fsub_rn(e[k], deficit), 0.0f);
    }
    if (lane == 0) {
      picks[step] = b;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        u[k] = nu[k];
        e[k] = ne[k];
      }
    }
    bool nneeds;
    const uint64_t nk = order_key(
        node_score<D>(a, nu, ask, ne, true, pscore, D, nd, &nneeds), b);
    top = refresh_top(keys, seg, segs, b, peer, nk);
  }
}

}  // namespace

// f32 words of nt_preempt_solve's scratch
extern "C" long long nt_preempt_solve_scratch_words(int n, int d) {
  return solve_in_smem(n) ? 2LL * n * d : key_offset(n, d) + 2LL * n;
}

template <int D>
static cudaError_t launch_solve(const void* avail, const void* used0,
                                const void* ask, const void* feasible,
                                const void* net_prio, const void* active,
                                const void* v_vec, const void* v_elig,
                                const void* v_flag, void* scratch,
                                void* picks, void* victims, void* flagged,
                                void* scores, int n, int v, int k,
                                cudaStream_t stream) {
  const bool in_smem = solve_in_smem(n);
  const size_t smem =
      (size_t)segments(n) * sizeof(uint64_t) +
      (in_smem ? (size_t)n * (sizeof(uint64_t) + sizeof(int)) : 0);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      preempt_solve_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  preempt_solve_kernel<D><<<1, kThreads, smem, stream>>>(
      (const float*)avail, (const float*)used0, (const float*)ask,
      (const uint8_t*)feasible, (const float*)net_prio,
      (const uint8_t*)active, (const float*)v_vec, (const uint8_t*)v_elig,
      (const uint8_t*)v_flag, (float*)scratch, in_smem, (int*)picks,
      (uint8_t*)victims, (uint8_t*)flagged, (float*)scores, n, v, k);
  return cudaGetLastError();
}

// avail, used0 (n, d) f32; ask (d,) f32; feasible (n,) bool; net_prio (n,)
// f32; active (k,) bool; v_vec (n, v, d) f32; v_elig, v_flag (n, v) bool;
// scratch nt_preempt_solve_scratch_words(n, d) f32 words, scratch_words
// their count (a smaller buffer is refused); picks (k,) int32, victims
// (k, v) bool (16-byte aligned), flagged (k,) bool, scores (k,) f32.
extern "C" int nt_preempt_solve(const void* avail, const void* used0,
                                const void* ask, const void* feasible,
                                const void* net_prio, const void* active,
                                const void* v_vec, const void* v_elig,
                                const void* v_flag, void* scratch,
                                void* picks, void* victims, void* flagged,
                                void* scores, int n, int v, int k, int d,
                                int scratch_words, void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || v <= 0 || d < 2 || d > kMaxDims ||
      nt_preempt_solve_scratch_words(n, d) > (long long)scratch_words) {
    return (int)cudaErrorInvalidValue;
  }
  auto launch = launch_solve<2>;
  switch (d) {
    case 3: launch = launch_solve<3>; break;
    case 4: launch = launch_solve<4>; break;
    case 5: launch = launch_solve<5>; break;
    case 6: launch = launch_solve<6>; break;
    case 7: launch = launch_solve<7>; break;
    case 8: launch = launch_solve<8>; break;
    default: break;
  }
  return (int)launch(avail, used0, ask, feasible, net_prio, active, v_vec,
                     v_elig, v_flag, scratch, picks, victims, flagged,
                     scores, n, v, k, (cudaStream_t)stream);
}

// f32 words of nt_preempt_pick's scratch
extern "C" long long nt_preempt_pick_scratch_words(int n, int d) {
  return 2LL * n * d + (pick_in_smem(n) ? 0 : 2LL * n);
}

template <int D>
static cudaError_t launch_pick(const void* avail, const void* used0,
                               const void* evictable0, const void* ask,
                               const void* feasible, const void* net_prio,
                               const void* active, void* scratch,
                               void* picks, int n, int k,
                               cudaStream_t stream) {
  const bool in_smem = pick_in_smem(n);
  const size_t smem = (size_t)(segments(n) + (in_smem ? n : 0)) *
                      sizeof(uint64_t);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      preempt_pick_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  preempt_pick_kernel<D><<<1, kThreads, smem, stream>>>(
      (const float*)avail, (const float*)used0, (const float*)evictable0,
      (const float*)ask, (const uint8_t*)feasible, (const float*)net_prio,
      (const uint8_t*)active, (float*)scratch, in_smem, (int*)picks, n, k);
  return cudaGetLastError();
}

// avail, used0, evictable0 (n, d) f32; ask (d,) f32; feasible (n,) bool;
// net_prio (n,) f32; active (k,) bool; scratch
// nt_preempt_pick_scratch_words(n, d) f32 words, scratch_words their
// count (a smaller buffer is refused); picks (k,) int32.
extern "C" int nt_preempt_pick(const void* avail, const void* used0,
                               const void* evictable0, const void* ask,
                               const void* feasible, const void* net_prio,
                               const void* active, void* scratch, void* picks,
                               int n, int k, int d, int scratch_words,
                               void* stream) {
  if (k <= 0) return 0;
  if (n <= 0 || d < 2 || d > kMaxDims ||
      nt_preempt_pick_scratch_words(n, d) > (long long)scratch_words) {
    return (int)cudaErrorInvalidValue;
  }
  auto launch = launch_pick<2>;
  switch (d) {
    case 3: launch = launch_pick<3>; break;
    case 4: launch = launch_pick<4>; break;
    case 5: launch = launch_pick<5>; break;
    case 6: launch = launch_pick<6>; break;
    case 7: launch = launch_pick<7>; break;
    case 8: launch = launch_pick<8>; break;
    default: break;
  }
  return (int)launch(avail, used0, evictable0, ask, feasible, net_prio,
                     active, scratch, picks, n, k, (cudaStream_t)stream);
}
