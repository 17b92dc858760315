// B8, the per-node score of score_nodes (nomad_tpu/tensor/kernels.py:113-249),
// as __device__ functions shared by task_group.cu (B9, B10) and
// bulk_scan.cu (B11).
//
// What score_node computes at one node, in f32 and in the reference's
// operation order, which is part of the answer:
//   ok      = feasible & all(used + ask <= avail) & distinct_hosts
//             & every distinct_property value below its limit
//   fitness = BestFit (or WorstFit) of (avail, used + ask)   (fit.cuh)
//   total   = fitness + anti + resched + affinity + dev + spread, each
//             added only where present (0.0 otherwise), then / (number
//             present + 1); NEG where !ok
//   spread  = the fixed pairwise tree over S of the per-spread boosts
//             (explicit target or even spread); it feeds the != 0 test
// A caller supplies the per-node columns through an accessor (ScratchNodes
// for the permuted column-major scratch of the scans) and the value tables
// in shared memory (Tables).
//
// Arithmetic: __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn and accurate powf,
// built with --fmad=false and no fast math, so a score equals the plain
// torch version's (tensor/kernels.py score_nodes_ref) bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "fit.cuh"

namespace nt_score {

constexpr int kMaxDims = 8;
constexpr int kMaxSpreads = 8;
constexpr int kMaxProps = 8;
constexpr float kNeg = -1.0e30f;

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

// Per-node reads of the scans (B9, B11): the permuted column-major
// scratch, position j.
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

  const float fitness =
      nt_fit::fit_score_alg(a0, a1, nu0, nu1, sc.spread_alg);
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
__device__ inline Tables carve_tables(char* smem, const Dims& dm) {
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

__device__ inline void load_tables(const Tables& tb, const Dims& dm,
                                   const float* spread_tab,
                                   const float* spread_meta,
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
__device__ inline void spread_stats(const Tables& tb, const Dims& dm) {
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

__device__ inline Scalars load_scalars(const float* scalars, int d) {
  Scalars sc;
  sc.tg_count = scalars[1];
  sc.dh_job = scalars[2] > 0.5f;
  sc.dh_tg = scalars[3] > 0.5f;
  sc.spread_alg = scalars[4] > 0.5f;
  for (int k = 0; k < kMaxDims; ++k) sc.ask[k] = k < d ? scalars[5 + k] : 0.0f;
  return sc;
}

// Shared-memory bytes of the value tables
inline size_t table_bytes(const Dims& dm) {
  return sizeof(int) * (size_t)(dm.s * dm.v + dm.p * dm.vd) +
         sizeof(float) * (size_t)(dm.s * dm.v + 5 * dm.s + dm.p);
}

}  // namespace nt_score
