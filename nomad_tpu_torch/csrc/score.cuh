// B8, the per-node score of score_nodes (nomad_tpu/tensor/kernels.py:113-249),
// as __device__ functions shared by task_group.cu (B9, B10),
// task_group_shard.cu (B16) and bulk_scan.cu (B11).
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
// The cached identity (B9 and B11, which rescore every node at every
// step). A step of those scans changes only the chosen nodes' own columns
// and the small count tables. So a node's score is split into:
//   node_terms  -- what depends on the node alone: ok_local (feasible,
//                  fits, distinct_hosts), head = (((fitness + anti') +
//                  0.0f) + aff') + dev', each primed term 0.0f where
//                  absent, exactly score_node's add chain up to the
//                  spread term with the reschedule term absent, and the
//                  divisor without the spread term, 1 + anti + aff + dev;
//                  recomputed only for a node whose columns changed;
//   value_tables -- what depends on the step's counts: for each spread k
//                  and value t, the boost spread_boost gives a node
//                  holding t (sok true); for each distinct_property k and
//                  value t, whether its count is below the limit; one
//                  entry a thread, rebuilt each step;
//   cached_score -- the node's table entries (-1.0f where it lacks the
//                  spread value), the same pairwise tree, head + the
//                  spread term where present, / (divisor + 1 where
//                  present); NEG unless ok_local and every
//                  distinct_property entry hold.
// This equals score_node bit for bit: every operation is score_node's,
// on the same operands, in the same order. score_node adds the terms
// left to right and the spread term last, so the head is a prefix of its
// chain; where the reschedule term is absent score_node adds 0.0f there
// too, so head's `x + 0.0f` is the same operation on the same x (it turns
// -0.0 into +0.0 in both). The divisor is a sum of 1.0f and 0/1 terms,
// an integer below 8, exact in any order. The only node whose reschedule
// term is present, the step's penalty node, is scored with score_node.
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

// One spread's boost for a node holding value t (reference
// kernels.py:182-223): explicit target ((desired - used_cnt) / desired) *
// weight, lowest_boost for a zero target, -1 without a target; or the
// even-spread boost from the counts without this placement.
__device__ __forceinline__ float spread_value_boost(const Tables& tb, int k,
                                                    int t, int v,
                                                    float lowest) {
  const float cur = (float)tb.scnt[k * v + t];
  if (tb.has_t[k] > 0.5f) {
    const float des = tb.desired[k * v + t];
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

// One spread's boost at one node; -1 where the node lacks the value.
template <class Nodes>
__device__ __forceinline__ float spread_boost(const Nodes& nd, int j, int k,
                                              const Tables& tb, int v,
                                              float lowest) {
  if (!nd.sok(j, k)) return -1.0f;
  return spread_value_boost(tb, k, nd.svid(j, k), v, lowest);
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
__host__ __device__ inline size_t table_bytes(const Dims& dm) {
  return sizeof(int) * (size_t)(dm.s * dm.v + dm.p * dm.vd) +
         sizeof(float) * (size_t)(dm.s * dm.v + 5 * dm.s + dm.p);
}

// ---------------------------------------------------------------------------
// the cached identity (B9, B11); the header states why it is exact
// ---------------------------------------------------------------------------

constexpr uint16_t kNoValue = 0xFFFF;  // a cached value id: the node lacks it
constexpr unsigned kDivMask = 0x7u;    // meta: the divisor without spread
constexpr unsigned kOkLocal = 0x8u;    // meta: feasible, fits, distinct_hosts

// A node's cached terms: head and meta (divisor base | ok_local bit).
struct NodeTerms {
  float head;
  uint16_t meta;
};

// Per-position caches: head (f32) and meta (u16) per position, then S
// rows of spread value ids and P rows of distinct_property value ids (u16,
// kNoValue where the node lacks the value), rows `stride` long.
struct NodeCache {
  float* head;
  uint16_t* meta;
  uint16_t* sv;
  uint16_t* dv;
  int stride;
};

// One node's columns in registers (node_terms' accessor for a node a
// thread has just loaded and updated, so nothing is read back)
struct NodeRow {
  float av[kMaxDims], us[kMaxDims];
  int ptg_, pjob_;
  bool feas_;
  float aff_, dev_;
  __device__ float avail(int, int k) const { return av[k]; }
  __device__ float used(int, int k) const { return us[k]; }
  __device__ int ptg(int) const { return ptg_; }
  __device__ int pjob(int) const { return pjob_; }
  __device__ bool feas(int) const { return feas_; }
  __device__ float aff(int) const { return aff_; }
  __device__ float dev(int) const { return dev_; }
};

// (the loops over the columns run to kMaxDims, so every load is issued
// before the first is used and the rows stay in registers)
template <class Nodes>
__device__ __forceinline__ NodeRow load_row(const Nodes& nd, int j, int d) {
  NodeRow r;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    r.av[k] = k < d ? nd.avail(j, k) : 0.0f;
    r.us[k] = k < d ? nd.used(j, k) : 0.0f;
  }
  r.ptg_ = nd.ptg(j);
  r.pjob_ = nd.pjob(j);
  r.feas_ = nd.feas(j);
  r.aff_ = nd.aff(j);
  r.dev_ = nd.dev(j);
  return r;
}

// The node's terms, operation for operation score_node's up to the
// spread term, with no reschedule term.
template <class Nodes>
__device__ __forceinline__ NodeTerms node_terms(const Nodes& nd, int j,
                                                const Dims& dm,
                                                const Scalars& sc) {
  const NodeRow r = load_row(nd, j, dm.d);
  bool ok = r.feas_;
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < dm.d) ok = ok && (__fadd_rn(r.us[k], sc.ask[k]) <= r.av[k]);
  }
  const int ptg = r.ptg_;
  if (sc.dh_job && r.pjob_ != 0) ok = false;
  if (sc.dh_tg && ptg != 0) ok = false;
  const float fitness = nt_fit::fit_score_alg(
      r.av[0], r.av[1], __fadd_rn(r.us[0], sc.ask[0]),
      __fadd_rn(r.us[1], sc.ask[1]), sc.spread_alg);
  const bool anti_present = ptg > 0;
  const float anti =
      __fdiv_rn(-__fadd_rn((float)ptg, 1.0f), fmaxf(sc.tg_count, 1.0f));
  const float aff = r.aff_;
  const bool aff_present = aff != 0.0f;
  const float dev = r.dev_;
  const bool dev_present = dev != 0.0f;
  float head = fitness;
  head = __fadd_rn(head, anti_present ? anti : 0.0f);
  head = __fadd_rn(head, 0.0f);  // the reschedule term, absent
  head = __fadd_rn(head, aff_present ? aff : 0.0f);
  head = __fadd_rn(head, dev_present ? dev : 0.0f);
  const unsigned div = 1u + (anti_present ? 1u : 0u) +
                       (aff_present ? 1u : 0u) + (dev_present ? 1u : 0u);
  return {head, (uint16_t)(div | (ok ? kOkLocal : 0u))};
}

// score_node's last add and its division, from the cached head and meta
// and the spread tree's total
__device__ __forceinline__ float finish_score(float head, unsigned meta,
                                              float spread_total) {
  const bool present = spread_total != 0.0f;
  const float total = __fadd_rn(head, present ? spread_total : 0.0f);
  const float divisor =
      __fadd_rn((float)(meta & kDivMask), present ? 1.0f : 0.0f);
  return __fdiv_rn(total, divisor);
}

// The lean cache of a scan with at most one spread and no
// distinct_property: per position its head and one word, meta in the low
// 16 bits and the spread value id (kNoValue where lacking) in the high.
__device__ __forceinline__ float lean_score(const float* head,
                                            const uint32_t* word, int i,
                                            const Dims& dm,
                                            const float* boost) {
  const uint32_t pk = word[i];
  if (!(pk & kOkLocal)) return kNeg;
  const uint32_t vid = pk >> 16;
  const float b = dm.s == 0 ? 0.0f : vid == kNoValue ? -1.0f : boost[vid];
  return finish_score(head[i], pk, b);
}

// One position's score from its cache and the step's value tables.
__device__ __forceinline__ float cached_score(const NodeCache& c, int i,
                                              const Dims& dm,
                                              const float* boost,
                                              const uint8_t* dpok) {
  const unsigned meta = c.meta[i];
  if (!(meta & kOkLocal)) return kNeg;
  for (int k = 0; k < dm.p; ++k) {
    const unsigned vid = c.dv[k * c.stride + i];
    if (vid == kNoValue || !dpok[k * dm.vd + vid]) return kNeg;
  }
  int width = 1;
  while (width < dm.s) width <<= 1;
  float b[kMaxSpreads];
#pragma unroll
  for (int k = 0; k < kMaxSpreads; ++k) {
    b[k] = 0.0f;
    if (k < dm.s) {
      const unsigned vid = c.sv[k * c.stride + i];
      b[k] = vid == kNoValue ? -1.0f : boost[k * dm.v + vid];
    }
  }
  // score_node's tree: halve from width until one is left
#pragma unroll
  for (int half = kMaxSpreads / 2; half >= 1; half >>= 1) {
    if (half < width) {
#pragma unroll
      for (int k = 0; k < half; ++k) b[k] = __fadd_rn(b[2 * k], b[2 * k + 1]);
    }
  }
  return finish_score(c.head[i], meta, b[0]);
}

// Row k of the boost table, by one warp: the count `add` names (where
// not null and not kNoValue) goes up by one first; then spread k's
// min/max/any of the counts (spread_stats' values, into tb) and the boost
// of each value.
__device__ inline void spread_row(const Tables& tb, const Dims& dm, int k,
                                  float lowest, float* boost,
                                  const uint16_t* add) {
  const int lane = threadIdx.x & 31;
  if (add != nullptr && lane == 0 && add[k] != kNoValue) {
    tb.scnt[k * dm.v + add[k]] += 1;
  }
  __syncwarp();
  int mn = 2147483647, mx = 0;
  bool any = false;
  for (int t = lane; t < dm.v; t += 32) {
    const int c = tb.scnt[k * dm.v + t];
    if (c > 0) {
      any = true;
      mn = c < mn ? c : mn;
      mx = c > mx ? c : mx;
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    tb.minc[k] = (float)mn;
    tb.maxc[k] = (float)mx;
    tb.anyp[k] = any ? 1.0f : 0.0f;
  }
  __syncwarp();
  for (int t = lane; t < dm.v; t += 32) {
    boost[k * dm.v + t] = spread_value_boost(tb, k, t, dm.v, lowest);
  }
}

// dpok entries first, first + stride, ...; the count `add` names (value
// add[S + k] of property k, where not null) goes up by one first, by the
// thread that then reads it.
__device__ inline void dp_entries(const Tables& tb, const Dims& dm,
                                  uint8_t* dpok, const uint16_t* add,
                                  int first, int stride) {
  for (int t = first; t < dm.p * dm.vd; t += stride) {
    const int k = t / dm.vd;
    if (add != nullptr && add[dm.s + k] == t - k * dm.vd) tb.dpcnt[t] += 1;
    dpok[t] = (float)tb.dpcnt[t] < tb.dplim[k] ? 1 : 0;
  }
}

// The step's value tables, by the whole block (the caller syncs after):
// warp k < S fills row k of boost (spread_row), the other threads dpok.
// boost and dpok may be null where S or P is 0. `add`, where not null,
// holds the last step's winner's value ids (S spread, then P property;
// kNoValue where it lacks one), whose counts go up by one first.
__device__ inline void value_tables(const Tables& tb, const Dims& dm,
                                    float lowest, float* boost,
                                    uint8_t* dpok, const uint16_t* add) {
  const int warp = threadIdx.x >> 5;
  if (warp < dm.s) {
    spread_row(tb, dm, warp, lowest, boost, add);
    return;
  }
  const int first = 32 * dm.s;
  dp_entries(tb, dm, dpok, add, (int)threadIdx.x - first,
             (int)blockDim.x - first);
}

// The same tables by one warp, for small ones (no block barrier needed
// around it): every row, then every dpok entry.
__device__ inline void warp_value_tables(const Tables& tb, const Dims& dm,
                                         float lowest, float* boost,
                                         uint8_t* dpok,
                                         const uint16_t* add) {
  for (int k = 0; k < dm.s; ++k) spread_row(tb, dm, k, lowest, boost, add);
  dp_entries(tb, dm, dpok, add, threadIdx.x & 31, 32);
  __syncwarp();
}

}  // namespace nt_score
