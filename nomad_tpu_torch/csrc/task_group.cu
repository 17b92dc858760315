// B8 (score_nodes) as a __device__ function, B9 (the K-step scan of
// solve_task_group_fused) and B10 (score_nodes_once) as C entry points.
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
// What one step computes (B8, per node, in f32 and in the reference's
// operation order, which is part of the answer):
//   ok      = feasible & all(used + ask <= avail) & distinct_hosts
//             & every distinct_property value below its limit
//   fitness = BestFit (or WorstFit) of (avail, used + ask)
//   total   = fitness + anti + resched + affinity + dev + spread, each
//             added only where present (0.0 otherwise), then / (number
//             present + 1); NEG where !ok
//   spread  = the fixed pairwise tree over S of the per-spread boosts
//             (explicit target or even spread); it feeds the != 0 test
// B9 repeats that K times in tie-permuted node space: the first maximal
// permuted position wins, and the carry (usage, placement counts, spread
// and distinct_property value counts, the lowest explicit boost) moves
// only where a node was found and the step is active.
//
// Bound on the H100: neither bytes nor operations. One launch moves
// ~N x 4 x (2D+6+2S+2P) bytes in and 12 K bytes out (under 1 MB at the
// cfg3 width, a fraction of a microsecond of HBM time) and does ~100 N K
// flops (a few microseconds at the 32-bit peak). The time goes to the K
// steps running one after another on one SM, each a full pass over the
// nodes plus a block-wide argmax and a single-thread carry update behind
// barriers.
//
// Design (B9): one CTA of 1024 threads runs the whole scan, so a step
// needs only __syncthreads, no launch. The CTA first gathers every
// per-node column into permuted order in a global scratch buffer
// (column-major, so each step's reads are coalesced and stay L2-resident)
// that also holds the usage and placement-count carry. The small value
// tables (spread counts, desired counts, distinct_property counts) live in
// shared memory. A step: each thread scores its N/1024 positions and keeps
// its best (score desc, position asc); warp shuffles and one shared-memory
// round give the block's first maximal position; thread 0 writes the
// step's outputs and updates the carry; a barrier ends the step. B10 runs
// the same __device__ score over the unpermuted layout, one thread a node.
//
// Arithmetic: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn and accurate powf,
// built with --fmad=false and no fast math, so scores and choices equal
// the plain torch version on the card bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kScoreThreads = 256;
constexpr int kMaxDims = 8;
constexpr int kMaxSpreads = 8;
constexpr int kMaxProps = 8;
constexpr float kNeg = -1.0e30f;
constexpr float kMaxFit = 18.0f;

// Problem sizes and the per-launch scalars.
struct Dims {
  int n, d, s, v, p, vd;
};

struct Scalars {
  float tg_count;
  bool dh_job, dh_tg, spread_alg;
  float ask[kMaxDims];
};

// The value tables in shared memory, and the per-spread min/max/any of
// the current counts (recomputed before each step).
struct Tables {
  int* scnt;        // (S, V)
  float* desired;   // (S, V)
  float* has_t;     // (S)
  float* weight;    // (S)
  float* minc;      // (S)
  float* maxc;      // (S)
  float* anyp;      // (S)
  int* dpcnt;       // (P, Vd)
  float* dplim;     // (P)
};

__device__ __forceinline__ float free_fraction(float avail, float used) {
  float ratio;
  if (avail > 0.0f) {
    ratio = __fdiv_rn(used, avail);
  } else {
    ratio = used > 0.0f ? INFINITY : 0.0f;
  }
  return __fsub_rn(1.0f, ratio);
}

// B2 with the WorstFit arm (reference kernels.py:40-79)
__device__ __forceinline__ float fit_score(float a0, float a1, float u0,
                                           float u1, bool spread_alg) {
  const float total = __fadd_rn(powf(10.0f, free_fraction(a0, u0)),
                                powf(10.0f, free_fraction(a1, u1)));
  const float binpack = fminf(fmaxf(__fsub_rn(20.0f, total), 0.0f), kMaxFit);
  const float spread = fminf(fmaxf(__fsub_rn(total, 2.0f), 0.0f), kMaxFit);
  return __fdiv_rn(spread_alg ? spread : binpack, kMaxFit);
}

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

// Per-node reads of B9: the permuted column-major scratch, position j.
// Columns: avail[D] | used[D] | ptg | pjob | feas | aff | dev | orig |
//          spread vid[S] | spread ok[S] | dp vid[P] | dp ok[P]
struct ScratchNodes {
  float* f;
  int* i32;
  int n, d, s, p;
  __device__ long long at(int col, int j) const { return (long long)col * n + j; }
  __device__ float avail(int j, int k) const { return f[at(k, j)]; }
  __device__ float used(int j, int k) const { return f[at(d + k, j)]; }
  __device__ int ptg(int j) const { return i32[at(2 * d, j)]; }
  __device__ int pjob(int j) const { return i32[at(2 * d + 1, j)]; }
  __device__ bool feas(int j) const { return f[at(2 * d + 2, j)] > 0.5f; }
  __device__ float aff(int j) const { return f[at(2 * d + 3, j)]; }
  __device__ float dev(int j) const { return f[at(2 * d + 4, j)]; }
  __device__ int orig(int j) const { return i32[at(2 * d + 5, j)]; }
  __device__ int svid(int j, int k) const { return i32[at(2 * d + 6 + k, j)]; }
  __device__ bool sok(int j, int k) const { return f[at(2 * d + 6 + s + k, j)] > 0.5f; }
  __device__ int dvid(int j, int k) const { return i32[at(2 * d + 6 + 2 * s + k, j)]; }
  __device__ bool dok(int j, int k) const { return f[at(2 * d + 6 + 2 * s + p + k, j)] > 0.5f; }
};

// One spread's boost at one node (reference kernels.py:182-223):
// explicit target ((desired - used_cnt) / desired) * weight, lowest_boost
// for a zero target, -1 without a target; or the even-spread boost from
// the counts without this placement; -1 where the node lacks the value.
template <class Nodes>
__device__ __forceinline__ float spread_boost(const Nodes& nd, int j, int k,
                                              const Tables& tb, int v,
                                              float lowest) {
  if (!nd.sok(j, k)) return -1.0f;
  const int vid = nd.svid(j, k);
  const float cur = (float)tb.scnt[k * v + vid];
  if (tb.has_t[k] > 0.5f) {
    const float des = tb.desired[k * v + vid];
    if (isnan(des)) return -1.0f;
    if (des == 0.0f) return lowest;
    const float used_cnt = __fadd_rn(cur, 1.0f);
    return __fmul_rn(__fdiv_rn(__fsub_rn(des, used_cnt), des), tb.weight[k]);
  }
  if (!(tb.anyp[k] > 0.5f)) return 0.0f;
  const float minc = tb.minc[k];
  const float maxc = tb.maxc[k];
  if (cur != minc) {
    return minc == 0.0f ? -1.0f : __fdiv_rn(__fsub_rn(minc, cur), minc);
  }
  if (minc == maxc) return -1.0f;
  if (minc == 0.0f) return 1.0f;
  return __fdiv_rn(__fsub_rn(maxc, minc), minc);
}

// B8 at one node (reference kernels.py:113-249).
template <class Nodes>
__device__ float score_node(const Nodes& nd, int j, const Dims& dm,
                            const Scalars& sc, const Tables& tb, int pen,
                            float lowest) {
  bool ok = nd.feas(j);
  float nu0 = 0.0f, nu1 = 0.0f, a0 = 0.0f, a1 = 0.0f;
  for (int k = 0; k < dm.d; ++k) {
    const float a = nd.avail(j, k);
    const float nu = __fadd_rn(nd.used(j, k), sc.ask[k]);
    ok = ok && (nu <= a);
    if (k == 0) { nu0 = nu; a0 = a; }
    if (k == 1) { nu1 = nu; a1 = a; }
  }
  const int ptg = nd.ptg(j);
  if (sc.dh_job && nd.pjob(j) != 0) ok = false;
  if (sc.dh_tg && ptg != 0) ok = false;
  for (int k = 0; k < dm.p; ++k) {
    const bool vok = nd.dok(j, k);
    const int at = tb.dpcnt[k * dm.vd + nd.dvid(j, k)];
    ok = ok && vok && ((float)at < tb.dplim[k]);
  }

  const float fitness = fit_score(a0, a1, nu0, nu1, sc.spread_alg);
  const bool anti_present = ptg > 0;
  const float anti =
      __fdiv_rn(-__fadd_rn((float)ptg, 1.0f), fmaxf(sc.tg_count, 1.0f));
  const bool resched_present = pen >= 0 && nd.orig(j) == pen;
  const float aff = nd.aff(j);
  const bool aff_present = aff != 0.0f;
  const float dev = nd.dev(j);
  const bool dev_present = dev != 0.0f;

  // fixed pairwise tree over S, zero-padded to a power of two
  float b[kMaxSpreads];
  int width = 1;
  while (width < dm.s) width <<= 1;
  for (int k = 0; k < width; ++k) {
    b[k] = k < dm.s ? spread_boost(nd, j, k, tb, dm.v, lowest) : 0.0f;
  }
  while (width > 1) {
    width >>= 1;
    for (int k = 0; k < width; ++k) b[k] = __fadd_rn(b[2 * k], b[2 * k + 1]);
  }
  const float spread_total = b[0];
  const bool spread_present = spread_total != 0.0f;

  float divisor = 1.0f;
  divisor = __fadd_rn(divisor, anti_present ? 1.0f : 0.0f);
  divisor = __fadd_rn(divisor, resched_present ? 1.0f : 0.0f);
  divisor = __fadd_rn(divisor, aff_present ? 1.0f : 0.0f);
  divisor = __fadd_rn(divisor, dev_present ? 1.0f : 0.0f);
  divisor = __fadd_rn(divisor, spread_present ? 1.0f : 0.0f);
  float total = fitness;
  total = __fadd_rn(total, anti_present ? anti : 0.0f);
  total = __fadd_rn(total, resched_present ? -1.0f : 0.0f);
  total = __fadd_rn(total, aff_present ? aff : 0.0f);
  total = __fadd_rn(total, dev_present ? dev : 0.0f);
  total = __fadd_rn(total, spread_present ? spread_total : 0.0f);
  const float final_score = __fdiv_rn(total, divisor);
  return ok ? final_score : kNeg;
}

// Carve the value tables out of dynamic shared memory.
__device__ Tables carve_tables(char* smem, const Dims& dm) {
  Tables tb;
  int* ip = reinterpret_cast<int*>(smem);
  tb.scnt = ip;
  ip += dm.s * dm.v;
  tb.dpcnt = ip;
  ip += dm.p * dm.vd;
  float* fp = reinterpret_cast<float*>(ip);
  tb.desired = fp;
  fp += dm.s * dm.v;
  tb.has_t = fp;
  fp += dm.s;
  tb.weight = fp;
  fp += dm.s;
  tb.minc = fp;
  fp += dm.s;
  tb.maxc = fp;
  fp += dm.s;
  tb.anyp = fp;
  fp += dm.s;
  tb.dplim = fp;
  return tb;
}

__device__ void load_tables(const Tables& tb, const Dims& dm,
                            const float* spread_tab, const float* spread_meta,
                            const float* dp_tab) {
  for (int t = threadIdx.x; t < dm.s * dm.v; t += blockDim.x) {
    tb.scnt[t] = (int)spread_tab[t];
    tb.desired[t] = spread_tab[dm.s * dm.v + t];
  }
  for (int t = threadIdx.x; t < dm.s; t += blockDim.x) {
    tb.has_t[t] = spread_meta[2 * t];
    tb.weight[t] = spread_meta[2 * t + 1];
  }
  for (int t = threadIdx.x; t < dm.p * dm.vd; t += blockDim.x) {
    const int row = t / dm.vd;
    tb.dpcnt[t] = (int)dp_tab[row * (dm.vd + 1) + t % dm.vd];
  }
  for (int t = threadIdx.x; t < dm.p; t += blockDim.x) {
    tb.dplim[t] = dp_tab[t * (dm.vd + 1) + dm.vd];
  }
}

// min over present (count > 0) values with the int32-max sentinel, max
// over present values, and whether any is present (kernels.py:201-206)
__device__ void spread_stats(const Tables& tb, const Dims& dm) {
  for (int k = threadIdx.x; k < dm.s; k += blockDim.x) {
    int mn = 2147483647, mx = 0;
    bool any = false;
    for (int t = 0; t < dm.v; ++t) {
      const int c = tb.scnt[k * dm.v + t];
      if (c > 0) {
        any = true;
        mn = c < mn ? c : mn;
        mx = c > mx ? c : mx;
      }
    }
    tb.minc[k] = (float)mn;
    tb.maxc[k] = (float)mx;
    tb.anyp[k] = any ? 1.0f : 0.0f;
  }
}

__device__ Scalars load_scalars(const float* scalars, int d) {
  Scalars sc;
  sc.tg_count = scalars[1];
  sc.dh_job = scalars[2] > 0.5f;
  sc.dh_tg = scalars[3] > 0.5f;
  sc.spread_alg = scalars[4] > 0.5f;
  for (int k = 0; k < kMaxDims; ++k) sc.ask[k] = k < d ? scalars[5 + k] : 0.0f;
  return sc;
}

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
  extern __shared__ char smem[];
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
  extern __shared__ char smem[];
  __shared__ float warp_score[32];
  __shared__ int warp_pos[32];
  __shared__ float lowest_sh;

  const int n = dm.n, d = dm.d, s = dm.s, p = dm.p;
  const int w = 2 * d + 6;
  const Tables tb = carve_tables(smem, dm);
  load_tables(tb, dm, spread_tab, spread_meta, dp_tab);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, p};

  // gather every per-node column into permuted (tie_perm) order
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int i = (int)node_mat[(long long)j * w + 2 * d + 5];
    const float* row = node_mat + (long long)i * w;
    for (int k = 0; k < 2 * d; ++k) scratch[nd.at(k, j)] = row[k];
    nd.i32[nd.at(2 * d, j)] = (int)row[2 * d];
    nd.i32[nd.at(2 * d + 1, j)] = (int)row[2 * d + 1];
    scratch[nd.at(2 * d + 2, j)] = row[2 * d + 2];
    scratch[nd.at(2 * d + 3, j)] = row[2 * d + 3];
    scratch[nd.at(2 * d + 4, j)] = row[2 * d + 4];
    nd.i32[nd.at(2 * d + 5, j)] = i;
    for (int k = 0; k < s; ++k) {
      nd.i32[nd.at(2 * d + 6 + k, j)] = (int)spread_node[(long long)k * n + i];
      scratch[nd.at(2 * d + 6 + s + k, j)] =
          spread_node[(long long)(s + k) * n + i];
    }
    for (int k = 0; k < p; ++k) {
      nd.i32[nd.at(2 * d + 6 + 2 * s + k, j)] = (int)dp_node[(long long)k * n + i];
      scratch[nd.at(2 * d + 6 + 2 * s + p + k, j)] =
          dp_node[(long long)(p + k) * n + i];
    }
  }
  if (threadIdx.x == 0) lowest_sh = scalars[0];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int step = 0; step < k_steps; ++step) {
    spread_stats(tb, dm);
    __syncthreads();
    const int pen = (int)step_mat[2 * step];
    const float lowest = lowest_sh;

    float best = -INFINITY;
    int best_j = 0x7fffffff;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float sc_j = score_node(nd, j, dm, sc, tb, pen, lowest);
      if (sc_j > best) {
        best = sc_j;
        best_j = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best, off);
      const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
      if (better(os, oj, best, best_j)) {
        best = os;
        best_j = oj;
      }
    }
    if (lane == 0) {
      warp_score[warp] = best;
      warp_pos[warp] = best_j;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      best = lane < nw ? warp_score[lane] : -INFINITY;
      best_j = lane < nw ? warp_pos[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, best, off);
        const int oj = __shfl_down_sync(0xffffffffu, best_j, off);
        if (better(os, oj, best, best_j)) {
          best = os;
          best_j = oj;
        }
      }
      if (lane == 0) {
        const int j = best_j;
        const bool found = step_mat[2 * step + 1] > 0.5f && best > kNeg;
        out[step] = (float)nd.orig(j);
        out[k_steps + step] = found ? 1.0f : 0.0f;
        out[2 * k_steps + step] = best;
        if (found) {
          // the chosen node's explicit boosts, at this step's counts
          float low = lowest;
          for (int k = 0; k < s; ++k) {
            if (tb.has_t[k] > 0.5f && nd.sok(j, k)) {
              low = fminf(low, spread_boost(nd, j, k, tb, dm.v, lowest));
            }
          }
          lowest_sh = low;
          for (int k = 0; k < d; ++k) {
            scratch[nd.at(d + k, j)] = __fadd_rn(nd.used(j, k), sc.ask[k]);
          }
          nd.i32[nd.at(2 * d, j)] += 1;
          nd.i32[nd.at(2 * d + 1, j)] += 1;
          for (int k = 0; k < s; ++k) {
            if (nd.sok(j, k)) tb.scnt[k * dm.v + nd.svid(j, k)] += 1;
          }
          for (int k = 0; k < p; ++k) {
            if (nd.dok(j, k)) tb.dpcnt[k * dm.vd + nd.dvid(j, k)] += 1;
          }
        }
      }
    }
    __syncthreads();
  }
}

size_t table_bytes(const Dims& dm) {
  return sizeof(int) * (size_t)(dm.s * dm.v + dm.p * dm.vd) +
         sizeof(float) * (size_t)(dm.s * dm.v + 5 * dm.s + dm.p);
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

extern "C" int nt_solve_task_group(const void* node_mat, const void* step_mat,
                                   const void* spread_node,
                                   const void* spread_tab,
                                   const void* spread_meta,
                                   const void* dp_node, const void* dp_tab,
                                   const void* scalars, void* scratch,
                                   void* out, int n, int d, int k, int s,
                                   int v, int p, int vd, void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || k < 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const size_t smem = table_bytes(dm);
  cudaError_t err = set_smem(solve_task_group_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  solve_task_group_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)node_mat, (const float*)step_mat,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)dp_node, (const float*)dp_tab,
      (const float*)scalars, (float*)scratch, (float*)out, k, dm);
  return (int)cudaGetLastError();
}
