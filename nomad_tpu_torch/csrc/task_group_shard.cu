// B16, the per-eval scan with its node rows sharded, as a C entry point over
// B8 (score_node, the __device__ score of score.cuh).
//
// Replaces: solve_task_group_sharded (nomad_tpu/tensor/sharding.py:107-122):
// B9, solve_task_group (kernels.py:267-378), run by XLA over node-sharded
// inputs, a global argmax each step. The plain torch version is
// solve_task_group_sharded_ref in tensor/sharding.py.
//
// Layout: shard s of S holds the canonical rows [s * n, (s + 1) * n) of the
// padded arrays in B9's packed layout (task_group.cu), except that
// node_mat's last column is each row's position in the tie-break order
// (the inverse of tie_perm), not tie_perm; step_mat, spread_tab,
// spread_meta, dp_tab and scalars are the same on every shard. Keeping the
// canonical rows (the reference's P("nodes")) and keying the argmax on
// (score desc, position asc) gives B9's choice: B9 takes the first maximal
// position of the permuted order, and a step that finds nothing still
// reports position 0, the node tie_perm[0].
//
// One CTA of 1024 threads per shard per step t = 0..K (nt_task_group_shard):
//   t == 0: copy the shard's rows into a column-major scratch (B9's
//           ScratchNodes columns, canonical order, the global row in the
//           "orig" column, plus one column of positions) and the value
//           counts and lowest boost into the shard's carry;
//   t > 0:  read the S candidates of step t - 1 from the shard's gather
//           buffer and take the best, the same on every shard; commit it:
//           the owner adds the ask to its row's usage and one to its
//           placement counts, and every shard adds the spread and
//           distinct_property value counts and lowers the lowest explicit
//           boost from the candidate's own value ids and ok flags (the
//           winner's row lives on one shard only); shard 0 writes output
//           column t - 1;
//   t < K:  score the shard's rows with B8 at step t and write the shard's
//           best, with its value ids and ok flags, into row s of its gather
//           buffer.
// Between steps the host all-gathers the buffers (sharding.all_gather). A
// candidate row (int32): score bits | position | global row | spread ids[S]
// | spread ok[S] | dp ids[P] | dp ok[P]. No launch waits on another's flags:
// on one card the shards' launches need not be resident together.
//
// Bound on the H100: the same work as B9, neither bytes nor operations (the
// bound of chip_smoke.py's scan_bound is under a microsecond). The time goes
// to the (K + 1) x S launches and K gathers of S x (S - 1) row copies, each
// issued from the host one after another: the solve is host-bound, as the
// other sharded programs (sharded.cu) are.
//
// Arithmetic: score.cuh's correctly rounded operations, built with
// --fmad=false and no fast math, and B9's commit order, so choices, founds
// and scores equal B9's (nt_solve_task_group) bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace {

using namespace nt_score;

constexpr int kThreads = 1024;

// (score desc, position asc): does (s1, p1) beat (s0, p0)? B9's order.
__device__ __forceinline__ bool better(float s1, int p1, float s0, int p0) {
  return s1 > s0 || (s1 == s0 && p1 < p0);
}

// A gathered candidate's value ids and ok flags, read as spread_boost reads
// a node's.
struct Candidate {
  const int* c;
  int s, p;
  __device__ int svid(int, int k) const { return c[3 + k]; }
  __device__ bool sok(int, int k) const { return c[3 + s + k] != 0; }
  __device__ int dvid(int k) const { return c[3 + 2 * s + k]; }
  __device__ bool dok(int k) const { return c[3 + 2 * s + p + k] != 0; }
};

// Reduce (score, position, row) over a warp by better().
__device__ __forceinline__ void warp_best(float& best, int& pos, int& row) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, best, off);
    const int op = __shfl_down_sync(0xffffffffu, pos, off);
    const int orow = __shfl_down_sync(0xffffffffu, row, off);
    if (better(os, op, best, pos)) {
      best = os;
      pos = op;
      row = orow;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
task_group_shard_kernel(const float* __restrict__ node_mat,
                        const float* __restrict__ step_mat,
                        const float* __restrict__ spread_node,
                        const float* __restrict__ spread_tab,
                        const float* __restrict__ spread_meta,
                        const float* __restrict__ dp_node,
                        const float* __restrict__ dp_tab,
                        const float* __restrict__ scalars,
                        float* __restrict__ scratch, int* __restrict__ carry,
                        int* __restrict__ gbuf, float* __restrict__ out,
                        int t, int k_steps, int shard, int n_shards, Dims dm) {
  extern __shared__ char smem[];
  __shared__ float warp_score[32];
  __shared__ int warp_pos[32];
  __shared__ int warp_row[32];
  __shared__ float lowest_sh;

  const int n = dm.n, d = dm.d, s = dm.s, p = dm.p;
  const int w = 2 * d + 6;
  const int pos_col = 2 * d + 6 + 2 * s + 2 * p;
  const int width = 3 + 2 * s + 2 * p;
  const int lo = shard * n;
  const Tables tb = carve_tables(smem, dm);
  load_tables(tb, dm, spread_tab, spread_meta, dp_tab);
  const Scalars sc = load_scalars(scalars, d);
  const ScratchNodes nd{scratch, reinterpret_cast<int*>(scratch), n, d, s, p};
  int* scnt_g = carry;
  int* dpcnt_g = carry + s * dm.v;
  int* lowest_g = dpcnt_g + p * dm.vd;

  if (t == 0) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const float* row = node_mat + (long long)j * w;
      for (int k = 0; k < 2 * d; ++k) scratch[nd.at(k, j)] = row[k];
      nd.i32[nd.at(2 * d, j)] = (int)row[2 * d];
      nd.i32[nd.at(2 * d + 1, j)] = (int)row[2 * d + 1];
      scratch[nd.at(2 * d + 2, j)] = row[2 * d + 2];
      scratch[nd.at(2 * d + 3, j)] = row[2 * d + 3];
      scratch[nd.at(2 * d + 4, j)] = row[2 * d + 4];
      nd.i32[nd.at(2 * d + 5, j)] = lo + j;
      nd.i32[nd.at(pos_col, j)] = (int)row[2 * d + 5];
      for (int k = 0; k < s; ++k) {
        nd.i32[nd.at(2 * d + 6 + k, j)] = (int)spread_node[(long long)k * n + j];
        scratch[nd.at(2 * d + 6 + s + k, j)] =
            spread_node[(long long)(s + k) * n + j];
      }
      for (int k = 0; k < p; ++k) {
        nd.i32[nd.at(2 * d + 6 + 2 * s + k, j)] = (int)dp_node[(long long)k * n + j];
        scratch[nd.at(2 * d + 6 + 2 * s + p + k, j)] =
            dp_node[(long long)(p + k) * n + j];
      }
    }
    if (threadIdx.x == 0) lowest_sh = scalars[0];
  } else {
    // the same threads wrote these entries in load_tables
    for (int i = threadIdx.x; i < s * dm.v; i += blockDim.x) tb.scnt[i] = scnt_g[i];
    for (int i = threadIdx.x; i < p * dm.vd; i += blockDim.x) tb.dpcnt[i] = dpcnt_g[i];
    if (threadIdx.x == 0) lowest_sh = __int_as_float(*lowest_g);
  }
  __syncthreads();

  if (t > 0) {
    if (threadIdx.x == 0) {
      int win = 0;
      for (int r = 1; r < n_shards; ++r) {
        if (better(__int_as_float(gbuf[r * width]), gbuf[r * width + 1],
                   __int_as_float(gbuf[win * width]), gbuf[win * width + 1])) {
          win = r;
        }
      }
      const Candidate cd{gbuf + win * width, s, p};
      const float best = __int_as_float(cd.c[0]);
      const int row = cd.c[2];
      const int step = t - 1;
      const bool found = step_mat[2 * step + 1] > 0.5f && best > kNeg;
      if (out != nullptr) {
        out[step] = (float)row;
        out[k_steps + step] = found ? 1.0f : 0.0f;
        out[2 * k_steps + step] = best;
      }
      if (found) {
        // the winner's explicit boosts, at this step's counts
        const float lowest = lowest_sh;
        float low = lowest;
        for (int k = 0; k < s; ++k) {
          if (tb.has_t[k] > 0.5f && cd.sok(0, k)) {
            low = fminf(low, spread_boost(cd, 0, k, tb, dm.v, lowest));
          }
        }
        lowest_sh = low;
        for (int k = 0; k < s; ++k) {
          if (cd.sok(0, k)) tb.scnt[k * dm.v + cd.svid(0, k)] += 1;
        }
        for (int k = 0; k < p; ++k) {
          if (cd.dok(k)) tb.dpcnt[k * dm.vd + cd.dvid(k)] += 1;
        }
        const int j = row - lo;
        if (j >= 0 && j < n) {
          for (int k = 0; k < d; ++k) {
            scratch[nd.at(d + k, j)] = __fadd_rn(nd.used(j, k), sc.ask[k]);
          }
          nd.i32[nd.at(2 * d, j)] += 1;
          nd.i32[nd.at(2 * d + 1, j)] += 1;
        }
      }
    }
    __syncthreads();
  }
  if (t == k_steps) return;

  // the carry for the next launch
  for (int i = threadIdx.x; i < s * dm.v; i += blockDim.x) scnt_g[i] = tb.scnt[i];
  for (int i = threadIdx.x; i < p * dm.vd; i += blockDim.x) dpcnt_g[i] = tb.dpcnt[i];
  if (threadIdx.x == 0) *lowest_g = __float_as_int(lowest_sh);

  spread_stats(tb, dm);
  __syncthreads();
  const int pen = (int)step_mat[2 * t];
  const float lowest = lowest_sh;
  float best = -INFINITY;
  int best_pos = INT_MAX;
  int best_j = -1;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float v = score_node(nd, j, dm, sc, tb, pen, lowest);
    const int pj = nd.i32[nd.at(pos_col, j)];
    if (better(v, pj, best, best_pos)) {
      best = v;
      best_pos = pj;
      best_j = j;
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_best(best, best_pos, best_j);
  if (lane == 0) {
    warp_score[warp] = best;
    warp_pos[warp] = best_pos;
    warp_row[warp] = best_j;
  }
  __syncthreads();
  if (warp != 0) return;
  const int nw = blockDim.x >> 5;
  best = lane < nw ? warp_score[lane] : -INFINITY;
  best_pos = lane < nw ? warp_pos[lane] : INT_MAX;
  best_j = lane < nw ? warp_row[lane] : -1;
  warp_best(best, best_pos, best_j);
  if (lane != 0) return;
  int* c = gbuf + shard * width;
  c[0] = __float_as_int(best);
  c[1] = best_pos;
  c[2] = best_j < 0 ? -1 : lo + best_j;
  for (int k = 0; k < s; ++k) {
    c[3 + k] = best_j < 0 ? 0 : nd.svid(best_j, k);
    c[3 + s + k] = best_j < 0 ? 0 : (int)nd.sok(best_j, k);
  }
  for (int k = 0; k < p; ++k) {
    c[3 + 2 * s + k] = best_j < 0 ? 0 : nd.dvid(best_j, k);
    c[3 + 2 * s + p + k] = best_j < 0 ? 0 : (int)nd.dok(best_j, k);
  }
}

}  // namespace

extern "C" int nt_task_group_shard(const void* node_mat, const void* step_mat,
                                   const void* spread_node,
                                   const void* spread_tab,
                                   const void* spread_meta,
                                   const void* dp_node, const void* dp_tab,
                                   const void* scalars, void* scratch,
                                   void* carry, void* gbuf, void* out, int t,
                                   int k, int n, int d, int shard,
                                   int n_shards, int s, int v, int p, int vd,
                                   void* stream) {
  const Dims dm{n, d, s, v, p, vd};
  if (n <= 0 || d < 2 || d > kMaxDims || s < 0 || s > kMaxSpreads || p < 0 ||
      p > kMaxProps || v <= 0 || vd <= 0 || k <= 0 || t < 0 || t > k ||
      shard < 0 || shard >= n_shards) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = table_bytes(dm);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        task_group_shard_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  task_group_shard_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)node_mat, (const float*)step_mat,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)dp_node, (const float*)dp_tab,
      (const float*)scalars, (float*)scratch, (int*)carry, (int*)gbuf,
      (float*)out, t, k, shard, n_shards, dm);
  return (int)cudaGetLastError();
}
