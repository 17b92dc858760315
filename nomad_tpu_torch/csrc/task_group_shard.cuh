// B16's kernel and its instances (task_group_shard.cu states what it
// computes and how), shared by task_group_shard.cu (the entry point and
// the narrow instances) and wide/task_group_shard.cu (the wide ones).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "mesh.cuh"
#include "score.cuh"
#include "sort.cuh"

namespace {

using namespace nt_score;
using nt_mesh::group_sync;
using nt_mesh::load_cg;

constexpr int kThreads = 1024;
constexpr int kPassWarps = 31;  // warps of the pass; the last commits
constexpr int kTile = 256;      // steps whose rows a CTA holds at once
constexpr int kWarpTable = 256;  // value tables warp 0 rebuilds alone
constexpr int kMaxShards = 64;
constexpr size_t kMaxSmem = 232448 - 1024;

// (score desc, position asc): does (s1, p1) beat (s0, p0)?
__device__ __forceinline__ bool better(float s1, int p1, float s0, int p0) {
  return s1 > s0 || (s1 == s0 && p1 < p0);
}

// the candidate row's int32 words: score bits | position | global row |
// the owner's slot | the value ids, two 16-bit ids a word (spread ids,
// then distinct_property ids); the narrow instance holds a row's id words
// in registers
constexpr int kIdWords = (kMaxSpreads + kMaxProps) / 2;
// the compaction's value ids held a thread at a time (wide instance)
constexpr int kIdGroup = kMaxSpreads + kMaxProps;
__host__ __device__ inline int cand_width(const Dims& dm) {
  return 4 + (dm.s + dm.p + 1) / 2;
}

// a shard's region: head[n] f32 | the caches' 16-bit words (meta[n],
// sv[S x n], dv[P x n]; or, lean, one 32-bit word a slot) | row[n] i32 (the
// slot's local row) | pos[n] i32 (its tie-break position)
__host__ __device__ inline long long cache_words(const Dims& dm) {
  const long long halves = (long long)dm.n * (1 + dm.s + dm.p);
  return (halves + 1) / 2 > dm.n ? (halves + 1) / 2 : dm.n;
}
__host__ __device__ inline long long region_words(const Dims& dm) {
  return 3LL * dm.n + cache_words(dm);
}

// the int32 words of a shard's scratch: the columns (n x (2D+6+2S+2P)),
// slot_of[n], the gather buffers (2, S, width), the region
struct ShardLayout {
  long long slot_of, gbuf, region, words;
};

__host__ __device__ inline ShardLayout shard_layout(const Dims& dm,
                                                    int shards) {
  ShardLayout l;
  long long at = (long long)dm.n * (2 * dm.d + 6 + 2 * dm.s + 2 * dm.p);
  l.slot_of = at;
  at += dm.n;
  l.gbuf = at;
  at += 2LL * shards * cand_width(dm);
  l.region = (at + 3) & ~3LL;
  l.words = l.region + region_words(dm);
  return l;
}

// the launch's arguments, one copy a card, by value (__grid_constant__)
struct TgArgs {
  // by global shard index
  const float* node_mat[kMaxShards];
  const float* spread_node[kMaxShards];
  const float* dp_node[kMaxShards];
  int* scratch[kMaxShards];  // every shard's: the pushes' targets
  int card_shards[kMaxShards];  // this card's shards, in mesh order
  // this card's copies of the replicated inputs
  const float* step_mat;
  const float* spread_tab;
  const float* spread_meta;
  const float* dp_tab;
  const float* scalars;
  float* out;          // (3, K), on shard 0's card
  unsigned* barrier;   // the group's words
  ShardLayout lay;
  Dims dm;
  int k, shards;
  int stride;  // the row length of spread_node and dp_node
  int group_ctas;
  int cross;           // the mesh spans cards: system-scope barriers
};

// Bytes of a CTA's shared memory before the region: the count tables,
// boost[S x V] f32, dpok[P x Vd] u8, the step tile (pen, the shard's
// penalty slot and act of 2 x kTile steps)
__host__ __device__ inline size_t base_bytes(const Dims& dm) {
  size_t b = (table_bytes(dm) + 15) / 16 * 16;
  b += 4 * (size_t)dm.s * dm.v + 4 * (((size_t)dm.p * dm.vd + 3) / 4);
  b += 2 * 4 * 2 * kTile + 2 * kTile;
  return (b + 15) / 16 * 16;
}

// Bytes of the wide instance's rows after base_bytes: the commit's usage
// (D f32), the winner's ids (S + P u16); none in the narrow instance
__host__ __device__ inline size_t wide_bytes(const Dims& dm) {
  return dims_wide(dm)
             ? (4 * (size_t)dm.d + 2 * (size_t)(dm.s + dm.p) + 15) / 16 * 16
             : 0;
}

// (score, position, slot) of the warp's best by better(), to every lane
__device__ __forceinline__ void warp_best(float& best, int& pos, int& slot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, best, off);
    const int op = __shfl_xor_sync(0xffffffffu, pos, off);
    const int ol = __shfl_xor_sync(0xffffffffu, slot, off);
    if (better(os, op, best, pos)) {
      best = os;
      pos = op;
      slot = ol;
    }
  }
}

// A winner's commit, computed from its columns: its usage and placement
// counts after the placement and its cached terms (B9's rescore)
struct Spec {
  float us[kMaxDims];
  int ptg, pjob;
  float head;
  uint16_t meta;
  int slot;  // the slot they belong to, -1 none
};

__device__ __forceinline__ void commit_terms(const ScratchNodes& nd, int r,
                                             const Dims& dm,
                                             const Scalars& sc, Spec& sp) {
  NodeRow row = load_row(nd, r, dm.d);
#pragma unroll
  for (int k = 0; k < kMaxDims; ++k) {
    if (k < dm.d) row.us[k] = __fadd_rn(row.us[k], sc.ask[k]);
    sp.us[k] = row.us[k];
  }
  row.ptg_ += 1;
  row.pjob_ += 1;
  sp.ptg = row.ptg_;
  sp.pjob = row.pjob_;
  const NodeTerms t = node_terms(row, 0, dm, sc);
  sp.head = t.head;
  sp.meta = t.meta;
}

// A row's columns after one more placement, its usage from `us` (the
// wide instance's commit terms, computed before the columns move)
struct PlacedRow {
  ScratchNodes nd;
  const float* us;
  __device__ float avail(int j, int k) const { return nd.avail(j, k); }
  __device__ float used(int, int k) const { return us[k]; }
  __device__ int ptg(int j) const { return nd.ptg(j) + 1; }
  __device__ int pjob(int j) const { return nd.pjob(j) + 1; }
  __device__ bool feas(int j) const { return nd.feas(j); }
  __device__ float aff(int j) const { return nd.aff(j); }
  __device__ float dev(int j) const { return nd.dev(j); }
};

// commit_terms with the usage row in `us` (shared memory), any D
__device__ __forceinline__ void commit_terms_wide(const ScratchNodes& nd,
                                                  int r, const Dims& dm,
                                                  const Scalars& sc, Spec& sp,
                                                  float* us) {
  for (int k = 0; k < dm.d; ++k) us[k] = __fadd_rn(nd.used(r, k), sc.askp[k]);
  sp.ptg = nd.ptg(r) + 1;
  sp.pjob = nd.pjob(r) + 1;
  const NodeTerms t = node_terms<true>(PlacedRow{nd, us}, r, dm, sc);
  sp.head = t.head;
  sp.meta = t.meta;
}

template <bool kShared, bool kLean, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
task_group_shard_kernel(const __grid_constant__ TgArgs a) {
  extern __shared__ __align__(16) char smem[];
  __shared__ float warp_score[32];
  __shared__ int warp_pos[32];
  __shared__ int warp_slot[32];
  __shared__ int live_sh, pending_sh, minpos_sh, minrow_sh;
  __shared__ float lowest_sh;
  __shared__ uint16_t win_vid[kMaxSpreads + kMaxProps];
  __shared__ Spec spec;

  const Dims dm = a.dm;
  const int n = dm.n, d = dm.d, s = dm.s, p = dm.p, v = dm.v;
  const int w = 2 * d + 6;
  const int width = cand_width(dm);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool warp_tables = s * v + p * dm.vd <= kWarpTable;
  unsigned* const words = a.barrier;
  if (a.cross) group_sync(words, a.group_ctas, true);

  const Tables tb = carve_tables(smem, dm);
  load_tables(tb, dm, a.spread_tab, a.spread_meta, a.dp_tab);
  const Scalars sc = load_scalars(a.scalars, d);
  char* tail = smem + (table_bytes(dm) + 15) / 16 * 16;
  float* boost = reinterpret_cast<float*>(tail);
  uint8_t* dpok = reinterpret_cast<uint8_t*>(boost + s * v);
  int* tile_pen = reinterpret_cast<int*>(dpok + 4 * ((p * dm.vd + 3) / 4));
  int* tile_slot = tile_pen + 2 * kTile;
  uint8_t* tile_act = reinterpret_cast<uint8_t*>(tile_slot + 2 * kTile);
  // the wide instance's commit usage and winner ids
  float* const spec_us = reinterpret_cast<float*>(smem + base_bytes(dm));
  uint16_t* const win_ids =
      kWide ? reinterpret_cast<uint16_t*>(spec_us + d) : win_vid;

  // the shard's pieces
  const int sh = a.card_shards[blockIdx.x];
  int* const scr = a.scratch[sh];
  const ScratchNodes nd{reinterpret_cast<float*>(scr), scr, n, d, s, p};
  int* const slot_of = scr + a.lay.slot_of;
  char* const base = kShared
                         ? smem + base_bytes(dm) + (kWide ? wide_bytes(dm) : 0)
                         : reinterpret_cast<char*>(scr + a.lay.region);
  float* const head = reinterpret_cast<float*>(base);
  uint16_t* const meta = reinterpret_cast<uint16_t*>(head + n);
  uint32_t* const word = reinterpret_cast<uint32_t*>(meta);  // lean
  const NodeCache cache{head, meta, meta + n, meta + n * (1 + s), n};
  int* const row_of = reinterpret_cast<int*>(word + cache_words(dm));
  int* const pos = row_of + n;
  const int lo = sh * n;

  // the start: the shard's columns, cached terms and live slots
  {
    const float* node_mat = a.node_mat[sh];
    const float* spread_node = a.spread_node[sh];
    const float* dp_node = a.dp_node[sh];
    int mp = INT_MAX, mr = 0;
    for (int r = tid; r < n; r += kThreads) {
      const float* src = node_mat + (long long)r * w;
      for (int k = 0; k < 2 * d; ++k) nd.f[nd.at(k, r)] = src[k];
      nd.i32[nd.at(2 * d, r)] = (int)src[2 * d];
      nd.i32[nd.at(2 * d + 1, r)] = (int)src[2 * d + 1];
      nd.f[nd.at(2 * d + 2, r)] = src[2 * d + 2];
      nd.f[nd.at(2 * d + 3, r)] = src[2 * d + 3];
      nd.f[nd.at(2 * d + 4, r)] = src[2 * d + 4];
      nd.i32[nd.at(2 * d + 5, r)] = lo + r;
      const int pr = (int)src[2 * d + 5];
      pos[r] = pr;
      if (pr < mp) {
        mp = pr;
        mr = r;
      }
      if (kLean) word[r] = (uint32_t)kNoValue << 16;
      for (int k = 0; k < s; ++k) {
        const int vid = (int)spread_node[(long long)k * a.stride + r];
        const float ok = spread_node[(long long)(s + k) * a.stride + r];
        nd.i32[nd.at(2 * d + 6 + k, r)] = vid;
        nd.f[nd.at(2 * d + 6 + s + k, r)] = ok;
        const uint16_t id = ok > 0.5f ? (uint16_t)vid : kNoValue;
        if (kLean) {
          word[r] = (uint32_t)id << 16;
        } else {
          cache.sv[k * n + r] = id;
        }
      }
      for (int k = 0; k < p; ++k) {
        const int vid = (int)dp_node[(long long)k * a.stride + r];
        const float ok = dp_node[(long long)(p + k) * a.stride + r];
        nd.i32[nd.at(2 * d + 6 + 2 * s + k, r)] = vid;
        nd.f[nd.at(2 * d + 6 + 2 * s + p + k, r)] = ok;
        cache.dv[k * n + r] = ok > 0.5f ? (uint16_t)vid : kNoValue;
      }
      const NodeTerms t = node_terms<kWide>(nd, r, dm, sc);
      head[r] = t.head;
      if (kLean) {
        word[r] = (word[r] & 0xffff0000u) | t.meta;
      } else {
        meta[r] = t.meta;
      }
    }
    // the lowest position of the shard's rows (equal scores: better()
    // compares the positions)
    float zero = 0.0f;
    warp_best(zero, mp, mr);
    if (lane == 0) {
      warp_pos[warp] = mp;
      warp_slot[warp] = mr;
    }
    __syncthreads();
    if (warp == 0) {
      int q = warp_pos[lane], qr = warp_slot[lane];
      zero = 0.0f;
      warp_best(zero, q, qr);
      if (lane == 0) {
        minpos_sh = q;
        minrow_sh = lo + qr;
      }
    }
    __syncthreads();  // warp_pos is the scan's next
    // keep the live rows (a row that is not ok_local never becomes so
    // again), in row order: row r moves to slot `live`, row_of[live] = r
    int live = 0;
    for (int first = 0; first < n; first += kThreads) {
      const int r = first + tid;
      bool ok = false;
      float h = 0.0f;
      uint32_t wd = 0u;
      int pr = 0;
      uint16_t ids[kMaxSpreads + kMaxProps];
      if (r < n) {
        h = head[r];
        wd = kLean ? word[r] : meta[r];
        ok = (wd & kOkLocal) != 0;
        pr = pos[r];
        if (!kLean && !kWide) {
          for (int k = 0; k < s; ++k) ids[k] = cache.sv[k * n + r];
          for (int k = 0; k < p; ++k) ids[s + k] = cache.dv[k * n + r];
        }
      }
      const int at = live + nt_sort::block_exclusive_scan(
                                ok ? 1 : 0, reinterpret_cast<int*>(warp_pos));
      if (r < n) slot_of[r] = ok ? at : -1;
      if (ok) {
        head[at] = h;
        pos[at] = pr;
        row_of[at] = r;
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
        // B9's wide compaction of the S + P id rows (dv follows sv)
        for (int g = 0; g < s + p; g += kIdGroup) {
          const int m = min(kIdGroup, s + p - g);
          if (ok) {
            for (int q = 0; q < m; ++q) ids[q] = cache.sv[(g + q) * n + r];
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
      live_sh = live;
      pending_sh = -1;
      spec.slot = -1;
      lowest_sh = a.scalars[0];
    }
    __syncthreads();
  }
  const int n_live = live_sh;

  // the rows of steps first .. first + kTile - 1: penalty, the shard's
  // live slot of it (-1 where none: a dead penalty row scores NEG
  // anyway), active
  const auto load_tile = [&](int first) {
    const int last = min(a.k, first + kTile);
    for (int t = first + tid; t < last; t += kThreads) {
      const int pen = (int)a.step_mat[2 * t];
      const int ts = t % (2 * kTile);
      tile_pen[ts] = pen;
      tile_slot[ts] = pen >= lo && pen < lo + n ? slot_of[pen - lo] : -1;
      tile_act[ts] = a.step_mat[2 * t + 1] > 0.5f ? 1 : 0;
    }
  };
  load_tile(0);
  value_tables<kWide>(tb, dm, lowest_sh, boost, dpok, nullptr);
  __syncthreads();

  int parity = 0;
  for (int step = 0; step < a.k; ++step) {
    const int tslot = step % (2 * kTile);
    const int pen = tile_pen[tslot];
    const int pslot = tile_slot[tslot];
    const int pending = pending_sh;
    const float lowest = lowest_sh;
    const long long gat = a.lay.gbuf + (long long)parity * a.shards * width;
    const auto score_at = [&](int l) {
      if (l == pslot) {
        return score_node<kWide>(nd, row_of[l], dm, sc, tb, pen, lowest);
      }
      return kLean ? lean_score(head, word, l, dm, boost)
                   : cached_score<kWide>(cache, l, dm, boost, dpok);
    };
    float best = -INFINITY;
    int best_p = INT_MAX, best_l = -1;
    if (warp < kPassWarps) {
      // the pass: every live slot but the last winner's
      for (int l = tid; l < n_live; l += kPassWarps * 32) {
        if (l == pending) continue;
        const float sc_l = score_at(l);
        if (sc_l >= best) {
          const int pl = pos[l];
          if (sc_l > best || pl < best_p) {
            best = sc_l;
            best_p = pl;
            best_l = l;
          }
        }
      }
    } else if (pending >= 0 && lane == 0) {
      // meanwhile the last winner's columns move and its terms are stored:
      // those computed ahead while the last step's barrier ran (the same
      // columns, the same operations), else computed now
      const int r = row_of[pending];
      if constexpr (kWide) {
        if (spec.slot != pending) {
          commit_terms_wide(nd, r, dm, sc, spec, spec_us);
        }
        for (int k = 0; k < d; ++k) nd.f[nd.at(d + k, r)] = spec_us[k];
      } else {
        if (spec.slot != pending) commit_terms(nd, r, dm, sc, spec);
#pragma unroll
        for (int k = 0; k < kMaxDims; ++k) {
          if (k < d) nd.f[nd.at(d + k, r)] = spec.us[k];
        }
      }
      nd.i32[nd.at(2 * d, r)] = spec.ptg;
      nd.i32[nd.at(2 * d + 1, r)] = spec.pjob;
      head[pending] = spec.head;
      if (kLean) {
        word[pending] = (word[pending] & 0xffff0000u) | spec.meta;
      } else {
        meta[pending] = spec.meta;
      }
      best = score_at(pending);
      best_p = pos[pending];
      best_l = pending;
    }
    warp_best(best, best_p, best_l);
    if (lane == 0) {
      warp_score[warp] = best;
      warp_pos[warp] = best_p;
      warp_slot[warp] = best_l;
    }
    __syncthreads();
    if (warp == kPassWarps) {
      // ahead of the barrier: the terms the shard's candidate takes if it
      // wins (the next pass stores them)
      best = warp_score[lane];
      best_p = warp_pos[lane];
      best_l = warp_slot[lane];
      warp_best(best, best_p, best_l);
      if (lane == 0) {
        spec.slot = -1;
        if (best > kNeg) {
          if constexpr (kWide) {
            commit_terms_wide(nd, row_of[best_l], dm, sc, spec, spec_us);
          } else {
            commit_terms(nd, row_of[best_l], dm, sc, spec);
          }
        }
        spec.slot = best > kNeg ? best_l : -1;
      }
    }
    if (warp == 0) {
      best = warp_score[lane];
      best_p = warp_pos[lane];
      best_l = warp_slot[lane];
      warp_best(best, best_p, best_l);
      // the shard's candidate, one word a lane
      const bool any = best > kNeg;
      const auto cand_id = [&](int k) -> unsigned {
        if (!any || k >= s + p) return kNoValue;
        return kLean    ? word[best_l] >> 16
               : k < s ? cache.sv[k * n + best_l]
                       : cache.dv[(k - s) * n + best_l];
      };
      // word wd by lane wd % 32 (the wide instance's row may be wider
      // than a warp)
      for (int wd = lane; wd < width; wd += 32) {
        int word_out;
        if (wd == 0) {
          word_out = __float_as_int(any ? best : kNeg);
        } else if (wd == 1) {
          word_out = any ? best_p : minpos_sh;
        } else if (wd == 2) {
          word_out = any ? lo + row_of[best_l] : minrow_sh;
        } else if (wd == 3) {
          word_out = any ? best_l : -1;
        } else {
          const int k = 2 * (wd - 4);
          word_out = (int)(cand_id(k) | (cand_id(k + 1) << 16));
        }
        const long long at = gat + (long long)sh * width + wd;
        for (int q = 0; q < a.shards; ++q) a.scratch[q][at] = word_out;
      }

      // one barrier of all CTAs, by warp 0 alone (the others wait for the
      // step's end below); then the gathered candidates and the same
      // winner on every CTA
      __syncwarp();
      if (lane == 0) {
        if (a.cross) {
          nt_mesh::group_arrive_wait<cuda::thread_scope_system>(
              words, a.group_ctas, nt_mesh::kBarrierTimeoutNs);
        } else {
          nt_mesh::group_arrive_wait<cuda::thread_scope_device>(
              words, a.group_ctas, nt_mesh::kBarrierTimeoutNs);
        }
      }
      __syncwarp();
      const int* gb = scr + gat;
      // lane q reads candidate q's whole row in one round
      float cs = -INFINITY;
      int cp = INT_MAX, cq = -1, crow = 0, cslot = -1;
      int cid[kIdWords] = {};
      if (lane < a.shards) {
        const int* c = gb + (long long)lane * width;
        cs = __int_as_float(load_cg(c));
        cp = load_cg(c + 1);
        crow = load_cg(c + 2);
        cslot = load_cg(c + 3);
        cq = lane;
        if (!kWide) {
#pragma unroll
          for (int w2 = 0; w2 < kIdWords; ++w2) {
            cid[w2] = 4 + w2 < width ? load_cg(c + 4 + w2) : 0;
          }
        }
      }
      for (int q = lane + 32; q < a.shards; q += 32) {
        const float qs = __int_as_float(load_cg(gb + (long long)q * width));
        const int qp = load_cg(gb + (long long)q * width + 1);
        if (better(qs, qp, cs, cp)) {
          cs = qs;
          cp = qp;
          cq = q;
        }
      }
      warp_best(cs, cp, cq);
      const float win = cs;
      int row, slot;
      unsigned pair = 0u;  // lane k's id pair word, k < kIdWords
      if (cq < 32) {
        row = __shfl_sync(0xffffffffu, crow, cq);
        slot = __shfl_sync(0xffffffffu, cslot, cq);
        if (!kWide) {
#pragma unroll
          for (int w2 = 0; w2 < kIdWords; ++w2) {
            const int x = __shfl_sync(0xffffffffu, cid[w2], cq);
            if (lane == w2) pair = (unsigned)x;
          }
        }
      } else {
        const int* c = gb + (long long)cq * width;
        row = load_cg(c + 2);
        slot = load_cg(c + 3);
        if (!kWide && 4 + lane < width) pair = (unsigned)load_cg(c + 4 + lane);
      }
      const bool found = tile_act[tslot] && win > kNeg;
      unsigned vid = kNoValue;
      float low = INFINITY;
      if constexpr (kWide) {
        // id k by lane k % 32, from the winner's row, into win_ids
        const int* c = gb + (long long)cq * width;
        for (int k = lane; k < s + p; k += 32) {
          unsigned id = kNoValue;
          if (found) {
            const unsigned w2 = (unsigned)load_cg(c + 4 + (k >> 1));
            id = k & 1 ? w2 >> 16 : w2 & 0xffffu;
          }
          if (k < s && id != kNoValue && tb.has_t[k] > 0.5f) {
            low = fminf(low, boost[k * v + id]);
          }
          win_ids[k] = (uint16_t)id;
        }
      } else {
        // lane k < S + P: id k, from the pair word of lane k / 2
        const unsigned pw = __shfl_sync(0xffffffffu, pair, lane >> 1);
        vid = found && lane < s + p ? (lane & 1 ? pw >> 16 : pw & 0xffffu)
                                    : kNoValue;
        if (lane < s && vid != kNoValue && tb.has_t[lane] > 0.5f) {
          low = boost[lane * v + vid];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        low = fminf(low, __shfl_xor_sync(0xffffffffu, low, off));
      }
      const float next_low = found ? fminf(lowest, low) : lowest;
      if (!kWide && lane < s + p) win_vid[lane] = (uint16_t)vid;
      if (lane == 0) {
        // the owner marks the winner's slot, rescored by the next pass
        pending_sh = found && row >= lo && row < lo + n ? slot : -1;
        if (sh == 0) {
          a.out[step] = (float)row;
          a.out[a.k + step] = found ? 1.0f : 0.0f;
          a.out[2 * a.k + step] = win;
        }
        lowest_sh = next_low;
      }
      __syncwarp();
      if (warp_tables && step + 1 < a.k) {
        warp_value_tables(tb, dm, next_low, boost, dpok, win_ids);
      }
    }
    if (!warp_tables && step + 1 < a.k) {
      __syncthreads();
      value_tables<kWide>(tb, dm, lowest_sh, boost, dpok, win_ids);
    }
    if ((step + 1) % kTile == 0 && step + 1 < a.k) load_tile(step + 1);
    __syncthreads();
    parity ^= 1;
  }
  if (a.cross) group_sync(words, a.group_ctas, true);
}

// every shape the reference takes; the host call checks the shared-memory
// limit
bool dims_ok(const Dims& dm) {
  return dm.n > 0 && dm.d >= 2 && dm.s >= 0 && dm.p >= 0 && dm.v > 0 &&
         dm.vd > 0;
}

// The instance for a shape: region in shared memory or not, the lean
// cache or not, of score.cuh's wide instance or not
template <bool kWide>
const void* shard_kernel(bool in_smem, bool lean) {
  if (in_smem) {
    return lean ? (const void*)task_group_shard_kernel<true, true, kWide>
                : (const void*)task_group_shard_kernel<true, false, kWide>;
  }
  return lean ? (const void*)task_group_shard_kernel<false, true, kWide>
              : (const void*)task_group_shard_kernel<false, false, kWide>;
}

}  // namespace

namespace nt_task_group_shard {

// shard_kernel<true>, in wide/task_group_shard.cu: a translation unit of
// its own, which nvcc compiles beside task_group_shard.cu and the linker
// puts into the same library
const void* wide_kernel(bool in_smem, bool lean);

}  // namespace nt_task_group_shard
