// B16, the per-eval scan with its node rows sharded: one host call and one
// cooperative launch a card a solve, every step inside it.
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
// spread_meta, dp_tab and scalars are the same on every shard (each
// card's copy is read). A shard's spread_node and dp_node columns lie in
// rows `stride` long: the wrapper packs the whole mesh's arguments once a
// card and passes each shard pointers into them. Keeping the canonical
// rows (the reference's P("nodes")) and keying the argmax on (score desc,
// position asc) gives B9's choice: B9 takes the first maximal position of
// the permuted order, and a step that finds nothing still reports
// position 0, the node tie_perm[0].
//
// One CTA a shard (a mesh has at most 64 shards, fewer than a card's SMs),
// each with B9's design over its own rows (score.cuh's cached identity):
// at the start it copies its rows into a column-major scratch
// (ScratchNodes, canonical order, the global row in the "orig" column),
// computes each row's cached terms (node_terms) and
// keeps those of the live rows (ok_local; dead rows never come back), with
// each one's local row and tie-break position, in shared memory (or in the
// shard's scratch where they do not fit, kShared false), and the lowest
// position of all its rows. Every CTA holds the value tables (the counts,
// the boost of each spread value, the below-limit flag of each
// distinct_property value, the lowest explicit boost): they are the same
// on every CTA, which computes them from the same gathered candidates.
// A step:
//   - the pass: 31 warps score the shard's live slots with cached_score
//     (lean_score: one word a slot, where S <= 1 and P = 0; score_node at
//     the step's penalty slot), while the last warp stores the shard's
//     last winner's new columns and terms; the best by (score desc,
//     position asc);
//   - the push: warp 0 writes the shard's candidate (score bits | position
//     | global row | its slot | the spread, then distinct_property, value
//     ids, two to a word, kNoValue where the row lacks one or its ok flag
//     is off) into row s of every shard's gather buffer at the step's
//     parity, through a peer pointer where that shard lies on another
//     card; a shard with no live slot above NEG pushes (NEG, its lowest
//     position, that row), so a step that finds nothing reports position
//     0. Meanwhile the last warp computes what the candidate's commit
//     would store (its columns after the placement and node_terms of them,
//     B9's rescore): the same whenever it is computed, so the owner alone
//     refreshes a node's terms and the step's critical path holds no powf;
//   - one barrier of all CTAs (mesh.cuh's group_arrive_wait, by warp 0
//     alone: the other warps wait for the step's end), then warp 0 of each
//     CTA reads the S candidates (load_cg, one round: lane q reads row q)
//     and takes the same winner. It writes the step's output column (shard
//     0's CTA), lowers the lowest boost from this step's table, and
//     rebuilds the value tables with the winner's ids added to the counts
//     (the winner's row lives on one shard only: the counts move by the
//     candidate's own ids); the owner marks the winner's slot (the
//     candidate carries it) for the next pass.
// The gather buffers are double-buffered by parity, so one barrier a step
// suffices: a CTA writes step t + 2's row only after every CTA passed
// barrier t + 1, which each reaches after reading step t's rows. Across
// cards the launch starts and ends on a barrier of all its CTAs: no CTA
// stores into a card's buffers before that card's launch began, and no
// launch ends while another may still store into its buffers.
//
// Bound on the H100: the same work as B9, neither bytes nor operations (the
// bound of chip_smoke.py's scan_bound is under a microsecond). The time
// goes to the K steps one after another, each a pass over a shard's live
// slots, two block reductions and one barrier of the mesh's CTAs.
//
// Arithmetic: score.cuh's correctly rounded operations, built with
// --fmad=false and no fast math, and B9's commit order, so choices, founds
// and scores equal B9's (nt_solve_task_group) bit for bit.

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
// then distinct_property ids)
constexpr int kIdWords = (kMaxSpreads + kMaxProps) / 2;
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

template <bool kShared, bool kLean>
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

  // the shard's pieces
  const int sh = a.card_shards[blockIdx.x];
  int* const scr = a.scratch[sh];
  const ScratchNodes nd{reinterpret_cast<float*>(scr), scr, n, d, s, p};
  int* const slot_of = scr + a.lay.slot_of;
  char* const base = kShared ? smem + base_bytes(dm)
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
      const NodeTerms t = node_terms(nd, r, dm, sc);
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
        if (!kLean) {
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
          for (int k = 0; k < s; ++k) cache.sv[k * n + at] = ids[k];
          for (int k = 0; k < p; ++k) cache.dv[k * n + at] = ids[s + k];
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
  value_tables(tb, dm, lowest_sh, boost, dpok, nullptr);
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
        return score_node(nd, row_of[l], dm, sc, tb, pen, lowest);
      }
      return kLean ? lean_score(head, word, l, dm, boost)
                   : cached_score(cache, l, dm, boost, dpok);
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
      if (spec.slot != pending) commit_terms(nd, r, dm, sc, spec);
#pragma unroll
      for (int k = 0; k < kMaxDims; ++k) {
        if (k < d) nd.f[nd.at(d + k, r)] = spec.us[k];
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
        if (best > kNeg) commit_terms(nd, row_of[best_l], dm, sc, spec);
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
      int word_out = 0;
      if (lane == 0) {
        word_out = __float_as_int(any ? best : kNeg);
      } else if (lane == 1) {
        word_out = any ? best_p : minpos_sh;
      } else if (lane == 2) {
        word_out = any ? lo + row_of[best_l] : minrow_sh;
      } else if (lane == 3) {
        word_out = any ? best_l : -1;
      } else if (lane < width) {
        const int k = 2 * (lane - 4);
        word_out = (int)(cand_id(k) | (cand_id(k + 1) << 16));
      }
      if (lane < width) {
        const long long at = gat + (long long)sh * width + lane;
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
#pragma unroll
        for (int w2 = 0; w2 < kIdWords; ++w2) {
          cid[w2] = 4 + w2 < width ? load_cg(c + 4 + w2) : 0;
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
#pragma unroll
        for (int w2 = 0; w2 < kIdWords; ++w2) {
          const int x = __shfl_sync(0xffffffffu, cid[w2], cq);
          if (lane == w2) pair = (unsigned)x;
        }
      } else {
        const int* c = gb + (long long)cq * width;
        row = load_cg(c + 2);
        slot = load_cg(c + 3);
        if (4 + lane < width) pair = (unsigned)load_cg(c + 4 + lane);
      }
      const bool found = tile_act[tslot] && win > kNeg;
      // lane k < S + P: id k, from the pair word of lane k / 2
      const unsigned pw = __shfl_sync(0xffffffffu, pair, lane >> 1);
      const unsigned vid =
          found && lane < s + p ? (lane & 1 ? pw >> 16 : pw & 0xffffu)
                                : kNoValue;
      float low = INFINITY;
      if (lane < s && vid != kNoValue && tb.has_t[lane] > 0.5f) {
        low = boost[lane * v + vid];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        low = fminf(low, __shfl_xor_sync(0xffffffffu, low, off));
      }
      const float next_low = found ? fminf(lowest, low) : lowest;
      if (lane < s + p) win_vid[lane] = (uint16_t)vid;
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
        warp_value_tables(tb, dm, next_low, boost, dpok, win_vid);
      }
    }
    if (!warp_tables && step + 1 < a.k) {
      __syncthreads();
      value_tables(tb, dm, lowest_sh, boost, dpok, win_vid);
    }
    if ((step + 1) % kTile == 0 && step + 1 < a.k) load_tile(step + 1);
    __syncthreads();
    parity ^= 1;
  }
  if (a.cross) group_sync(words, a.group_ctas, true);
}

bool dims_ok(const Dims& dm) {
  return dm.n > 0 && dm.d >= 2 && dm.d <= kMaxDims && dm.s >= 0 &&
         dm.s <= kMaxSpreads && dm.p >= 0 && dm.p <= kMaxProps && dm.v > 0 &&
         dm.vd > 0;
}

}  // namespace

// int32 words of each shard's scratch at these sizes (n: a shard's rows)
extern "C" long long nt_task_group_shard_solve_scratch_words(
    int n, int d, int s, int v, int p, int vd, int shards) {
  return shard_layout(Dims{n, d, s, v, p, vd}, shards).words;
}

// B16: K placements of one task group over a node-sharded mesh, one
// cooperative launch a card. Arrays of S (by shard): node_mat, step_mat,
// spread_node, spread_tab, spread_meta, dp_node, dp_tab and scalars (each
// shard's pack, on its card: node_mat its n rows, spread_node and dp_node
// its n columns of rows `stride` long; the replicated ones read from each
// card's first shard) and scratch (nt_task_group_shard_solve_scratch_words
// each);
// out (3, K) f32 and the barrier words on shard 0's card. shard_card: each
// shard's place among the ``cards`` distinct cards, ordinals theirs. A
// card holds one CTA an SM (1024 threads), so a card with more shards than
// SMs returns cudaErrorCooperativeLaunchTooLarge (at most kMaxShards, 64,
// shards: never on an H100, 132 SMs).
extern "C" int nt_task_group_shard_solve(
    const void* const* node_mat, const void* const* step_mat,
    const void* const* spread_node, const void* const* spread_tab,
    const void* const* spread_meta, const void* const* dp_node,
    const void* const* dp_tab, const void* const* scalars,
    void* const* scratch, void* out, void* barrier, const int* shard_card,
    const int* ordinals, int cards, int shards, int k, int n, int d, int s,
    int v, int p, int vd, int stride, void* const* streams) {
  static std::mutex launching;
  const std::lock_guard<std::mutex> hold(launching);
  const Dims dm{n, d, s, v, p, vd};
  if (!dims_ok(dm) || k < 1 || shards < 1 || shards > kMaxShards ||
      cards < 1 || cards > nt_mesh::kMaxCards || cards > shards ||
      stride < n)
    return (int)cudaErrorInvalidValue;
  int count[nt_mesh::kMaxCards] = {0};
  for (int c = 0; c < cards; ++c) {
    if (ordinals[c] < 0 || ordinals[c] >= nt_mesh::kMaxCards)
      return (int)cudaErrorInvalidValue;
  }
  for (int q = 0; q < shards; ++q) {
    if (shard_card[q] < 0 || shard_card[q] >= cards)
      return (int)cudaErrorInvalidValue;
    ++count[shard_card[q]];
  }
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  if (cards > 1) err = nt_mesh::enable_peers(ordinals, cards);
  // every card holds its CTAs at once (one an SM), or none is launched
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 ordinals[c]);
    if (err == cudaSuccess && count[c] > sms)
      err = cudaErrorCooperativeLaunchTooLarge;
  }
  if (err != cudaSuccess) {
    cudaSetDevice(caller);
    return (int)err;
  }
  // the regions in shared memory where they fit
  const size_t base = base_bytes(dm);
  const size_t region = 4 * (size_t)region_words(dm);
  const bool in_smem = base + region <= kMaxSmem;
  const size_t smem = base + (in_smem ? region : 0);
  if (smem > kMaxSmem) {
    cudaSetDevice(caller);
    return (int)cudaErrorInvalidValue;
  }
  const bool lean = s <= 1 && p == 0;
  auto kernel = in_smem ? (lean ? task_group_shard_kernel<true, true>
                                : task_group_shard_kernel<true, false>)
                        : (lean ? task_group_shard_kernel<false, true>
                                : task_group_shard_kernel<false, false>);
  TgArgs args{};
  for (int q = 0; q < shards; ++q) {
    args.node_mat[q] = (const float*)node_mat[q];
    args.spread_node[q] = (const float*)spread_node[q];
    args.dp_node[q] = (const float*)dp_node[q];
    args.scratch[q] = (int*)scratch[q];
  }
  args.out = (float*)out;
  args.barrier = (unsigned*)barrier;
  args.lay = shard_layout(dm, shards);
  args.dm = dm;
  args.k = k;
  args.shards = shards;
  args.stride = stride;
  args.cross = cards > 1;
  args.group_ctas = shards;
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    int nc = 0, first = -1;
    for (int q = 0; q < shards; ++q) {
      if (shard_card[q] == c) {
        if (first < 0) first = q;
        args.card_shards[nc++] = q;
      }
    }
    args.step_mat = (const float*)step_mat[first];
    args.spread_tab = (const float*)spread_tab[first];
    args.spread_meta = (const float*)spread_meta[first];
    args.dp_tab = (const float*)dp_tab[first];
    args.scalars = (const float*)scalars[first];
    err = cudaSetDevice(ordinals[c]);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) break;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel((const void*)kernel,
                                      dim3(nc),
                                      dim3(kThreads), params, smem,
                                      (cudaStream_t)streams[c]);
  }
  const cudaError_t back = cudaSetDevice(caller);
  if (err == cudaSuccess) err = back;
  return (int)err;
}
