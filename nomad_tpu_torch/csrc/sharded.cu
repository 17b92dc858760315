// B13, B14 and B15: the node-sharded solve of nomad_tpu/tensor/sharding.py.
//
// Replaces:
//   B15 nt_scatter_shards     make_state_scatter_sharded (sharding.py:144-179)
//                             and the correction fold of B13/B14 (:213-220,
//                             :427-432, with their max(., 0) clamp)
//   B13 nt_bulk_shard_solve   _bulk_shard_body (:198-315) under
//                             make_solve_bulk_multi_sharded (:318-365)
//   B14 nt_joint_shard_solve  _joint_body of make_solve_batch_sharded
//                             (:368-629): the greedy arm (B13's body), the
//                             auction restarts (:452-541), det_score
//                             (:550-561) and the pick (:563-606)
//
// Layout. Shard s of S owns the global node rows [s * n_loc, (s+1) * n_loc)
// and its own arrays on its card: (n_loc, 4) rows, (G, n_loc) columns, and
// a scratch buffer whose layout this file owns (bulk_layout, joint_layout;
// the wrapper sizes it with nt_*_scratch_words). The replicated state (the
// reference's replicated while-loop carry) is kept once per CTA, and every
// CTA computes it from the same gathered pools.
//
// One host call, one launch a card. nt_bulk_shard_solve and
// nt_joint_shard_solve take the mesh as small host arrays (every shard's
// pointers, each shard's card, the cards' ordinals and stream handles, as
// nt_scatter_shards does) and make one cooperative launch on each distinct
// card, holding the CTAs of that card's shards: B13 one CTA a shard, B14
// one a shard for the greedy arm and one a shard for each of the T
// restarts, all running at once. Every round of every eval runs inside the
// launch; the host reads no flag. The all-gather is in the kernel: each CTA
// stores its pool row straight into every shard's pool buffer (through a
// peer pointer when that shard lies on another card), then the group
// barrier of mesh.cuh. Pools are double-buffered by round parity, so one
// barrier a round suffices: a CTA writes round r + 2's rows only after
// every CTA of its group passed barrier r + 1, which each reaches after
// reading round r's. Groups: B13's CTAs; in B14 the greedy arm's CTAs,
// each restart's own CTAs (restarts end at different rounds), and all CTAs
// once more, to join before the arm scores (each CTA pushes its arm's
// per-node contributions to every shard) and the pick. Across cards every
// launch also starts and ends on a barrier of all its CTAs: no CTA stores
// into a card's buffers before that card's launch began (its stream's
// earlier work is done), and no launch ends while another card may still
// store into or read its buffers. Where a card cannot hold all its CTAs at
// once, one CTA takes several shards of a group in turn and arrives once
// for all of them.
//
// B13's rounds. An eval's keys (score + jitter) do not change while it
// runs: a round only zeroes the caps of the nodes it consumed. So a shard
// scores and caps its nodes once, in the eval's first round, and sorts its
// live nodes (cap > 0) once, in top_k's order (sort.cuh's bitonic sort, as
// B1 sorts once an eval; select.cuh's level search is not needed, the
// order being kept for the eval's rounds); each round's pool is then
// the next R entries of that order whose cap is still > 0, found from a
// cursor past the dead prefix. Slots past the live entries hold (NEG, 0, a
// negative id): the reference puts other dead nodes' ids there, but an
// entry of value NEG is never eligible and takes nothing, so no output
// reads those ids (tests/test_torch_mesh_loop.py holds this). Above 16,384
// nodes a shard (kSortNodes) the live keys do not fit one CTA's shared
// memory: the eval's start only scores and caps, and each round selects
// its pool afresh (pool_select): select.cuh's threshold_radix over the
// shard's nodes in node order, keyed by topk_desc of the eval's key and
// weighing 1 while the cap is > 0, read in place in the scratch, so a fill
// of R takes the R best live nodes in top_k's order; the chosen are sorted
// in shared memory. A shard holds up to 65,536 nodes.
//
// B14's pick sums up to 65,536 nodes in all: the pairwise tree over chunks
// of 16,384 in shared memory (kTreeChunk), then over the chunks' sums by
// the same halving, which is the padded tree's order of adds.
//
// Bound on the H100: neither bytes nor operations, as for B1 and B5. B13's
// first round sorts a shard's live keys in shared memory (one CTA a
// shard; above 16,384 nodes a shard each round's selection reads its
// keys and caps from L2 instead); B14's bids rescan every (eval, node)
// pair of the shard each round. The merges are small: S x R <= 2,048
// entries (B13), G x S x 16 (B14). Each round costs one barrier (a few
// microseconds on one card).
//
// Exactness. The per-node arithmetic is B1's and B5's (fit.cuh, correctly
// rounded division, no contraction: --fmad=false), the jitter B3's and
// B3''s (threefry.cuh, drawn in the kernel). Pools keep the reference's f32
// triplets (key, cap, global id). The local top-R is jax.lax.top_k's order
// (value desc in the total order, -0.0 below +0.0, index asc); the merges
// are lexsort's / lax.sort's (key desc with -0.0 equal to +0.0, global id
// asc). Usage adds are of integral f32 values, so the atomics of the fold
// are exact in any order. Every output equals the plain torch version
// (tensor/sharding.py) on the card.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "fit.cuh"
#include "mesh.cuh"
#include "select.cuh"
#include "sort.cuh"
#include "threefry.cuh"
#include "topr.cuh"

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1.0e30f;
constexpr int kMaxMerge = 2048;    // B13: S x R entries a merge sorts
constexpr int kMaxJoint = 1024;    // B14: G x 16 surfaced entries a round
constexpr int kMaxG = 64;
constexpr int kMaxTree = 65536;    // B14: nodes the pick's tree sums
constexpr int kTreeChunk = 16384;  // B14: the tree's nodes in shared memory
constexpr int kMaxFillNodes = 65536;  // B13: a shard's nodes (ROADMAP A11d)
constexpr int kSortNodes = 16384;  // B13: keys one CTA sorts in shared memory
constexpr int kMaxShards = 64;
constexpr int kMaxCards = 64;
constexpr int kMaxRestarts = 8;

using nt_fit::fit_score;
using nt_fit::preempt_score;
using nt_mesh::group_sync;
using nt_mesh::kGroupWords;
using nt_mesh::load_cg;
using nt_select::kRadixWords;
using nt_select::may_take;
using nt_select::Summary;
using nt_select::summarize;
using nt_select::take_at;
using nt_select::Threshold;
using nt_select::threshold_base;
using nt_select::threshold_radix;
using nt_sort::bitonic_sort;
using nt_sort::block_exclusive_scan;
using nt_sort::block_pairwise_sum;
using nt_sort::desc_key;
using nt_threefry::bits_to_unit;
using nt_threefry::fold_key;
using nt_threefry::threefry_bits;
using nt_topr::bid_key;
using nt_topr::key_idx;
using nt_topr::key_val;
using nt_topr::kTopR;
using nt_topr::topr_insert;
using nt_topr::warp_topr;

// top_k's descending order as an ascending uint32: the complement of the
// float's total-order image (-0.0 below +0.0)
__device__ __forceinline__ uint32_t topk_desc(float v) {
  const uint32_t u = __float_as_uint(v);
  return ~((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}

// merge key of a pool entry: value desc with -0.0 == +0.0, then id asc
// (the id offset by 2^31 so that the negative ids of empty slots order too)
__device__ __forceinline__ uint64_t merge_key(float v, float gid) {
  return ((uint64_t)desc_key(v) << 32) |
         (uint64_t)((uint32_t)(int)gid ^ 0x80000000u);
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ---------------------------------------------------------------------------
// the scratch layouts (int32 words of one shard's buffer)
// ---------------------------------------------------------------------------

__host__ __device__ inline long long round4(long long x) {
  return (x + 3) & ~3LL;
}

// B13: the eval's keys (f32 bits), caps, takes and sorted live order, then
// the double-buffered pools (2, S, 3, R) f32
struct BulkLayout {
  long long key, cap, take, order, pools, words;
};

__host__ __device__ inline BulkLayout bulk_layout(int n_loc, int shards,
                                                  int r) {
  BulkLayout l;
  long long at = 0;
  l.key = at;
  at += round4(n_loc);
  l.cap = at;
  at += round4(n_loc);
  l.take = at;
  at += round4(n_loc);
  l.order = at;
  at += round4(n_loc);
  l.pools = at;
  at += round4(2LL * shards * 3 * r);
  l.words = at;
  return l;
}

// B14: the greedy arm's B13 area, its carry (n_loc, 4) f32, counts (G,
// n_loc) int16 and rounds (G,); the restarts' rounds (T,), carries (T,
// n_loc, 4), takes (T, G, n_loc), price slices (T, n_loc), jitter (T, G,
// n_loc), double-buffered pools (2, T, S, 3, G, rl); the arms'
// contributions (S, T + 1, n_loc) f32 and placed totals (S, T + 1)
struct JointLayout {
  BulkLayout bulk;
  long long used_g, counts_g, rounds_g, rounds_t, used_t, take_t, price_t,
      jit_t, pools, contrib, placed, words;
};

__host__ __device__ inline JointLayout joint_layout(int g, int n_loc,
                                                    int shards, int r, int rl,
                                                    int n_t) {
  JointLayout l;
  l.bulk = bulk_layout(n_loc, shards, r);
  long long at = l.bulk.words;
  l.used_g = at;
  at += round4(4LL * n_loc);
  l.counts_g = at;
  at += round4(((long long)g * n_loc + 1) / 2);
  l.rounds_g = at;
  at += round4(g);
  l.rounds_t = at;
  at += round4(n_t);
  l.used_t = at;
  at += round4(4LL * n_t * n_loc);
  l.take_t = at;
  at += round4((long long)n_t * g * n_loc);
  l.price_t = at;
  at += round4((long long)n_t * n_loc);
  l.jit_t = at;
  at += round4((long long)n_t * g * n_loc);
  l.pools = at;
  at += round4(2LL * n_t * shards * 3 * g * rl);
  l.contrib = at;
  at += round4((long long)shards * (n_t + 1) * n_loc);
  l.placed = at;
  at += round4((long long)shards * (n_t + 1));
  l.words = at;
  return l;
}

// ---------------------------------------------------------------------------
// the launch's arguments, one copy a card, by value (__grid_constant__)
// ---------------------------------------------------------------------------

struct ShardArgs {
  // by global shard index
  float* used[kMaxShards];        // B13: the carry, in place; B14: the
                                  // folded carry, read only
  const float* avail[kMaxShards];
  const uint8_t* feas[kMaxShards];
  const float* aff[kMaxShards];
  const float* evict[kMaxShards];     // B14, or null
  const float* net_prio[kMaxShards];  // B14, or null
  int16_t* counts[kMaxShards];        // the counts out
  float* used_out[kMaxShards];        // B14: the carry out
  int* scratch[kMaxShards];           // every shard's: the pushes' targets
  int card_shards[kMaxShards];        // this card's shards, in mesh order
  // this card's copies of the replicated inputs
  const float* ask;         // (G, 4)
  const int* k;             // (G,)
  const long long* seeds;   // (G,) in [0, 2^32)
  // on shard 0's card
  int* rounds;      // B13: (G,)
  float* info;      // B14: (6,)
  int* gathers;     // B14: ()
  unsigned* barrier;  // the groups' words, kGroupWords each
  JointLayout lay;
  float span;                    // the greedy fill's jitter width
  float spans[kMaxRestarts];     // the restarts' jitter widths
  float eps[kMaxRestarts];       // the restarts' price temperatures
  int n_card;       // this card's shards
  int per_cta;      // shards a CTA takes in turn
  int ctas_here;    // CTAs of one group on this card
  int group_ctas;   // CTAs of one group over all cards
  int g, n_loc, shards, r, rl, rg, n_t, rounds_cap;
  int joint;        // B14 (the greedy arm's carry and counts in scratch)
  int cross;        // the mesh spans cards: system-scope barriers
};

// This CTA's shards of its group: card_shards[j * per .. ) on this card.
struct Team {
  int my[kMaxShards];
  unsigned char mine[kMaxShards];
  int n;
};

__device__ void team_init(const ShardArgs& a, int j, Team& team) {
  for (int s = threadIdx.x; s < kMaxShards; s += blockDim.x) team.mine[s] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int lo = j * a.per_cta;
    const int hi = min(lo + a.per_cta, a.n_card);
    team.n = hi - lo;
    for (int i = lo; i < hi; ++i) {
      team.my[i - lo] = a.card_shards[i];
      team.mine[a.card_shards[i]] = 1;
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned* group_words(const ShardArgs& a, int i) {
  return a.barrier + (long long)i * kGroupWords;
}

// ---------------------------------------------------------------------------
// B13: the distributed greedy fill, every eval and round in the launch
// ---------------------------------------------------------------------------

__device__ __forceinline__ float* fill_used(const ShardArgs& a, int s) {
  return a.joint ? reinterpret_cast<float*>(a.scratch[s] + a.lay.used_g)
                 : a.used[s];
}

__device__ __forceinline__ int16_t* fill_counts(const ShardArgs& a, int s) {
  return a.joint ? reinterpret_cast<int16_t*>(a.scratch[s] + a.lay.counts_g)
                 : a.counts[s];
}

// the eval's start on shard s (sharding.py:223-249): score, cap, key and
// jitter of every node, then, up to kSortNodes a shard, the live nodes
// (cap > 0) sorted once in top_k's order into the shard's order array (above
// it each round selects its pool: pool_select). Returns the live count.
__device__ int fill_start(const ShardArgs& a, int s, int e, uint64_t* keys,
                          int* warp_tot) {
  __shared__ int s_total;
  const int n_loc = a.n_loc;
  const bool sorted = n_loc <= kSortNodes;
  const int lo = s * n_loc;
  int* sc = a.scratch[s];
  float* key_loc = reinterpret_cast<float*>(sc + a.lay.bulk.key);
  int* cap_loc = sc + a.lay.bulk.cap;
  int* take_loc = sc + a.lay.bulk.take;
  int* order = sc + a.lay.bulk.order;
  const float budget_f = (float)a.k[e];
  const uint32_t seed = (uint32_t)a.seeds[e];
  float a_g[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) a_g[d] = a.ask[e * kDims + d];
  const float* u_s = fill_used(a, s);
  const float* av_s = a.avail[s];
  const uint8_t* feas_g = a.feas[s] + (long long)e * n_loc;
  const float* aff_g = a.aff[s] + (long long)e * n_loc;
  int base = 0;
  for (int c0 = 0; c0 < n_loc; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    int live = 0;
    float key = 0.0f;
    if (i < n_loc) {
      float u[kDims], av[kDims], nu[kDims];
      bool ok = feas_g[i] != 0;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        u[d] = u_s[i * kDims + d];
        av[d] = av_s[i * kDims + d];
        nu[d] = __fadd_rn(u[d], a_g[d]);
        ok = ok && (nu[d] <= av[d]);
      }
      const float af = aff_g[i];
      const bool aff_present = af != 0.0f;
      float score = __fdiv_rn(
          __fadd_rn(fit_score(av, nu), aff_present ? af : 0.0f),
          aff_present ? 2.0f : 1.0f);
      if (!ok) score = kNeg;
      float per = INFINITY;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        if (a_g[d] > 0.0f) {
          per = fminf(per,
                      floorf(__fdiv_rn(__fsub_rn(av[d], u[d]), a_g[d])));
        }
      }
      float cap_f = fmaxf(per, 0.0f);
      if (!(score > kNeg)) cap_f = 0.0f;
      const float jit = bits_to_unit(
          threefry_bits(0u, seed, 0u, (uint32_t)(lo + i)), a.span);
      key = __fadd_rn(score, jit);
      const int cap = (int)fminf(cap_f, budget_f);
      key_loc[i] = key;
      cap_loc[i] = cap;
      take_loc[i] = 0;
      live = cap > 0;
    }
    const int excl = block_exclusive_scan(live, warp_tot);
    if (threadIdx.x == kThreads - 1) s_total = excl + live;
    __syncthreads();
    if (live && sorted) {
      keys[base + excl] = ((uint64_t)topk_desc(key) << 32) | (uint64_t)i;
    }
    base += s_total;
  }
  if (sorted && base > 0) {
    const int p = pow2_at_least(base);
    for (int j = base + threadIdx.x; j < p; j += kThreads) keys[j] = ~0ull;
    __syncthreads();
    bitonic_sort(keys, p);
    for (int j = threadIdx.x; j < base; j += kThreads) {
      order[j] = (int)(keys[j] & 0xFFFFFFFFu);
    }
  }
  __syncthreads();
  return base;
}

// Above kSortNodes a shard, select.cuh's positions over the shard's nodes
// in node order: thread t holds nodes t x chunk .. t x chunk + chunk - 1,
// each keyed by topk_desc of the eval's key and weighing 1 while its cap is
// > 0, read in place in the scratch. The keys (key asc, position asc) are
// top_k's order, so a fill of R takes the R best live nodes.
struct DescKeys {
  const float* k;
  __device__ uint32_t operator[](int i) const { return topk_desc(k[i]); }
};
struct LiveCaps {
  const int* c;
  __device__ uint32_t operator[](int i) const { return c[i] > 0 ? 1u : 0u; }
};
template <int kQ>
struct PoolPositions {
  static constexpr int kMaxQ = kQ;
  DescKeys key;
  LiveCaps cap;
  int chunk, n;
  __device__ int count() const {
    const int first = (int)threadIdx.x * chunk;
    return max(0, min(chunk, n - first));
  }
  __device__ int slot(int q) const { return (int)threadIdx.x * chunk + q; }
};

// shard s's R best live nodes (sharding.py:251-256's top_k over the live
// keys) without a sorted order: threshold_radix's level of a fill of R,
// the chosen packed as (topk_desc(key), node) into sel and sorted there.
// Returns how many (R, or the live count where it is smaller).
template <int kQ>
__device__ int pool_select(const ShardArgs& a, int s, uint64_t* sel,
                           int* warp_tot) {
  __shared__ uint32_t hist[kRadixWords];
  __shared__ uint32_t red[10 * kWarps];
  const int r = a.r, n_loc = a.n_loc;
  const int* sc = a.scratch[s];
  const PoolPositions<kQ> ps{
      {reinterpret_cast<const float*>(sc + a.lay.bulk.key)},
      {sc + a.lay.bulk.cap}, (n_loc + kThreads - 1) / kThreads, n_loc};
  for (int i = threadIdx.x; i < kRadixWords; i += kThreads) hist[i] = 0u;
  int parity = 0;
  const Summary sm = summarize(ps, (uint32_t)r);
  const Threshold th =
      threshold_radix(ps, sm, (uint32_t)r, hist, red, parity);
  const long long base = threshold_base(ps, sm, th, (uint32_t)r, warp_tot);
  const bool may = may_take(sm, th);
  const int m = ps.count();
  int mine = 0;
  long long excl = base;
  for (int q = 0; q < m && may; ++q) {
    const int i = ps.slot(q);
    mine += take_at(ps.key[i], ps.cap[i], th, (uint32_t)r, excl) != 0u;
  }
  int at = block_exclusive_scan(mine, warp_tot);
  excl = base;
  for (int q = 0; q < m && may; ++q) {
    const int i = ps.slot(q);
    const uint32_t key = ps.key[i];
    if (take_at(key, ps.cap[i], th, (uint32_t)r, excl)) {
      sel[at++] = ((uint64_t)key << 32) | (uint64_t)i;
    }
  }
  const int found = th.all ? (int)th.total : r;
  if (found > 0) {
    const int p = pow2_at_least(found);
    for (int j = found + threadIdx.x; j < p; j += kThreads) sel[j] = ~0ull;
    __syncthreads();
    bitonic_sort(sel, p);
  }
  __syncthreads();
  return found;
}

// one round's pool of shard s: the next R entries of its order whose cap is
// still > 0 (from the cursor past the dead prefix; above kSortNodes a
// shard, pool_select's), then (NEG, 0, -1 - (s R + j)) slots; pushed into
// every shard's pool buffer at parity par
__device__ void fill_pool(const ShardArgs& a, int s, int n_live, int* cursor,
                          int par, uint64_t* smem, int* warp_tot) {
  __shared__ int s_total, s_first;
  const int r = a.r;
  const int lo = s * a.n_loc;
  const int* sc = a.scratch[s];
  const float* key_loc = reinterpret_cast<const float*>(sc + a.lay.bulk.key);
  const int* cap_loc = sc + a.lay.bulk.cap;
  const int* order = sc + a.lay.bulk.order;
  const bool sorted = a.n_loc <= kSortNodes;
  float* stage = reinterpret_cast<float*>(
      sorted ? smem : smem + pow2_at_least(r));
  int found = 0, first = -1;
  __syncthreads();  // the stage of the team's previous shard is pushed
  if (!sorted) {
    found = a.n_loc <= 32 * kThreads ? pool_select<32>(a, s, smem, warp_tot)
                                     : pool_select<64>(a, s, smem, warp_tot);
    for (int q = threadIdx.x; q < found; q += kThreads) {
      const int li = (int)(smem[q] & 0xFFFFFFFFu);
      stage[q] = key_loc[li];
      stage[r + q] = (float)cap_loc[li];
      stage[2 * r + q] = (float)(li + lo);
    }
  }
  for (int c = *cursor; sorted && c < n_live && found < r; c += kThreads) {
    const int j = c + threadIdx.x;
    int li = 0, live = 0;
    if (j < n_live) {
      li = order[j];
      live = cap_loc[li] > 0;
    }
    if (threadIdx.x == 0) s_first = INT_MAX;
    const int excl = block_exclusive_scan(live, warp_tot);
    if (threadIdx.x == kThreads - 1) s_total = excl + live;
    if (live) {
      atomicMin(&s_first, j);
      const int q = found + excl;
      if (q < r) {
        stage[q] = key_loc[li];
        stage[r + q] = (float)cap_loc[li];
        stage[2 * r + q] = (float)(li + lo);
      }
    }
    __syncthreads();
    if (first < 0 && s_total > 0) first = s_first;
    found += s_total;
    __syncthreads();
  }
  for (int q = min(found, r) + threadIdx.x; q < r; q += kThreads) {
    stage[q] = kNeg;
    stage[r + q] = 0.0f;
    stage[2 * r + q] = (float)(-1 - (s * r + q));
  }
  if (threadIdx.x == 0 && sorted) *cursor = first < 0 ? n_live : first;
  __syncthreads();
  const long long at = a.lay.bulk.pools + ((long long)par * a.shards + s) * 3 * r;
  for (int d = 0; d < a.shards; ++d) {
    float* dst = reinterpret_cast<float*>(a.scratch[d] + at);
    for (int i = threadIdx.x; i < 3 * r; i += kThreads) dst[i] = stage[i];
  }
}

// the round's merge (sharding.py:251-305) over the gathered pools in the
// team's first shard's buffer, the same on every CTA: the consumed takes
// and zeroed caps of the team's own rows. Returns the budget left; *go the
// loop condition.
__device__ int fill_merge(const ShardArgs& a, const Team& team, int par,
                          int budget, int* go, uint64_t* smem,
                          int* warp_tot) {
  __shared__ float s_thresh;
  __shared__ int s_consumed, s_go, s_left;
  const int S = a.shards, r = a.r, n_loc = a.n_loc;
  const float* pools = reinterpret_cast<const float*>(
      a.scratch[team.my[0]] + a.lay.bulk.pools + (long long)par * S * 3 * r);
  const int m = S * r;
  const int pm = pow2_at_least(m);
  uint64_t* skey = smem;
  float* sval = reinterpret_cast<float*>(skey + pm);
  int* scap = reinterpret_cast<int*>(sval + pm);
  int* sgid = scap + pm;

  // the gathered pools, keyed (key desc with -0.0 == +0.0, global id asc)
  for (int j = threadIdx.x; j < pm; j += kThreads) {
    uint64_t w = ~0ull;
    if (j < m) {
      const float* pool = pools + (long long)(j / r) * 3 * r;
      const int i = j % r;
      w = merge_key(load_cg(pool + i), load_cg(pool + 2 * r + i));
    }
    skey[j] = w;
  }
  if (threadIdx.x == 0) {
    // worst pool entry of the best-covered shard
    float t = load_cg(pools + r - 1);
    for (int q = 1; q < S; ++q) {
      t = fmaxf(t, load_cg(pools + (long long)q * 3 * r + r - 1));
    }
    s_thresh = t;
    s_consumed = 0;
  }
  __syncthreads();
  bitonic_sort(skey, pm);
  // each entry finds its place in the sorted keys (they are unique)
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const float* pool = pools + (long long)(j / r) * 3 * r;
    const int i = j % r;
    const float v = load_cg(pool + i);
    const float gid = load_cg(pool + 2 * r + i);
    const uint64_t w = merge_key(v, gid);
    int lo = 0, hi = pm;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (skey[mid] <= w) lo = mid; else hi = mid;
    }
    sval[lo] = v;
    scap[lo] = (int)load_cg(pool + r + i);
    sgid[lo] = (int)gid;
  }
  __syncthreads();

  // consume in that order: eligible above the threshold, the best always
  const int chunk = pm >= kThreads ? pm / kThreads : 1;
  const int q0 = threadIdx.x * chunk;
  int caps_e[kMaxMerge / kThreads];  // chunk <= kMaxMerge / kThreads
  int local = 0;
  for (int c = 0; c < chunk; ++c) {
    const int q = q0 + c;
    int ce = 0;
    if (q < m) {
      const bool elig = q == 0 ? sval[0] > kNeg : sval[q] > s_thresh;
      ce = elig ? scap[q] : 0;
    }
    caps_e[c] = ce;
    local += ce;
  }
  int excl = block_exclusive_scan(q0 < pm ? local : 0, warp_tot);
  int consumed = 0;
  for (int c = 0; c < chunk; ++c) {
    const int q = q0 + c;
    if (q >= m) break;
    int take = budget - excl;
    take = take < 0 ? 0 : (take > caps_e[c] ? caps_e[c] : take);
    excl += caps_e[c];
    consumed += take;
    const bool elig = q == 0 ? sval[0] > kNeg : sval[q] > s_thresh;
    const int gid = sgid[q];
    if (gid >= 0 && team.mine[gid / n_loc]) {
      const int owner = gid / n_loc;
      int* sc = a.scratch[owner];
      const int pos = gid - owner * n_loc;
      sc[a.lay.bulk.take + pos] += take;
      if (elig) sc[a.lay.bulk.cap + pos] = 0;
    }
  }
  if (consumed) atomicAdd(&s_consumed, consumed);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int left = budget - s_consumed;
    s_go = left > 0 && sval[0] > kNeg && s_consumed > 0;
    s_left = left;
  }
  __syncthreads();
  *go = s_go;
  const int left = s_left;
  __syncthreads();
  return left;
}

// the eval's end on shard s (sharding.py:306-312): usage and counts
__device__ void fill_end(const ShardArgs& a, int s, int e, bool ran) {
  const int n_loc = a.n_loc;
  const int* take_loc = a.scratch[s] + a.lay.bulk.take;
  int16_t* counts = fill_counts(a, s) + (long long)e * n_loc;
  if (!ran) {
    for (int i = threadIdx.x; i < n_loc; i += kThreads) counts[i] = 0;
    return;
  }
  float a_g[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) a_g[d] = a.ask[e * kDims + d];
  float* u_s = fill_used(a, s);
  for (int i = threadIdx.x; i < n_loc; i += kThreads) {
    const int t = take_loc[i];
    const float tf = (float)t;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      u_s[i * kDims + d] =
          __fadd_rn(u_s[i * kDims + d], __fmul_rn(a_g[d], tf));
    }
    counts[i] = (int16_t)t;
  }
}

// every eval of the chain, every round, for the team's shards; a group
// barrier a round. The owner of shard 0 writes the rounds.
__device__ void fill_loop(const ShardArgs& a, const Team& team,
                          unsigned* words, uint64_t* smem, int* warp_tot) {
  __shared__ int s_live[kMaxShards], s_cursor[kMaxShards];
  int* rounds = a.joint ? a.scratch[0] + a.lay.rounds_g : a.rounds;
  int parity = 0;
  for (int e = 0; e < a.g; ++e) {
    int budget = a.k[e];
    int go = budget > 0;
    const bool ran = go;
    int rnd = 0;
    if (go) {
      for (int i = 0; i < team.n; ++i) {
        const int live = fill_start(a, team.my[i], e, smem, warp_tot);
        if (threadIdx.x == 0) {
          s_live[i] = live;
          s_cursor[i] = 0;
        }
      }
      __syncthreads();
    }
    while (go) {
      for (int i = 0; i < team.n; ++i) {
        fill_pool(a, team.my[i], s_live[i], &s_cursor[i], parity, smem,
                  warp_tot);
      }
      group_sync(words, a.group_ctas, a.cross);
      budget = fill_merge(a, team, parity, budget, &go, smem, warp_tot);
      parity ^= 1;
      ++rnd;
    }
    for (int i = 0; i < team.n; ++i) fill_end(a, team.my[i], e, ran);
    if (team.mine[0] && threadIdx.x == 0) rounds[e] = rnd;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bulk_solve_kernel(const __grid_constant__ ShardArgs a) {
  extern __shared__ uint64_t smem[];
  __shared__ int warp_tot[32];
  __shared__ Team team;
  team_init(a, blockIdx.x, team);
  unsigned* words = group_words(a, 0);
  if (a.cross) group_sync(words, a.group_ctas, true);
  fill_loop(a, team, words, smem, warp_tot);
  if (a.cross) group_sync(words, a.group_ctas, true);
}

// ---------------------------------------------------------------------------
// B14: the auction restarts, the arm scores and the pick
// ---------------------------------------------------------------------------
//
// Restart t of shard s: used_t[t] (n_loc, 4), take_t[t] (G, n_loc),
// price_t[t] (n_loc,) (the shard's slice of the replicated (N,) price:
// nothing else of it is read), jit_t[t] (G, n_loc); the remaining demand
// per eval, the round and the go flag are replicated (the team's shared
// memory).

// bids over shard s's nodes and each row's top rl, two warps a row; the
// pool (value, cap, global id), an empty slot as (NEG, 0, a negative id),
// pushed into every shard's buffer of restart t at parity par
__device__ void joint_bids(const ShardArgs& a, int t, int s, int par,
                           const int* s_rem, const float (*s_ask)[kDims],
                           uint64_t* cand_base, float* stage) {
  const int g = a.g, n_loc = a.n_loc, rl = a.rl;
  const int lo = s * n_loc;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint64_t(*cand)[2][kTopR] =
      reinterpret_cast<uint64_t(*)[2][kTopR]>(cand_base);
  int* sc = a.scratch[s];
  const float* used =
      reinterpret_cast<const float*>(sc + a.lay.used_t) +
      (long long)t * n_loc * kDims;
  const float* price =
      reinterpret_cast<const float*>(sc + a.lay.price_t) + (long long)t * n_loc;
  const float* jit = reinterpret_cast<const float*>(sc + a.lay.jit_t) +
                     (long long)t * g * n_loc;
  const float* av_s = a.avail[s];
  const float* ev_s = a.evict[s];
  const float* npr_s = a.net_prio[s];
  const bool has_evict = ev_s != nullptr;

  for (int row = warp >> 1; row < g; row += kWarps / 2) {
    uint64_t lst[kTopR];
#pragma unroll
    for (int i = 0; i < kTopR; ++i) lst[i] = 0;
    if (s_rem[row] > 0) {
      float a_g[kDims];
#pragma unroll
      for (int d = 0; d < kDims; ++d) a_g[d] = s_ask[row][d];
      const uint8_t* feas_g = a.feas[s] + (long long)row * n_loc;
      const float* aff_g = a.aff[s] + (long long)row * n_loc;
      const float* jit_g = jit + (long long)row * n_loc;
      for (int i = (warp & 1) * 32 + lane; i < n_loc; i += 64) {
        if (!feas_g[i]) continue;
        float av[kDims], nu[kDims];
        bool ok = true;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          av[d] = av_s[i * kDims + d];
          const float cap_d =
              has_evict ? __fadd_rn(av[d], ev_s[i * kDims + d]) : av[d];
          nu[d] = __fadd_rn(used[i * kDims + d], a_g[d]);
          ok = ok && (nu[d] <= cap_d);
        }
        if (!ok) continue;
        const float af = aff_g[i];
        const bool aff_present = af != 0.0f;
        const float aff_term = aff_present ? af : 0.0f;
        const float divisor = aff_present ? 2.0f : 1.0f;
        float score;
        if (!has_evict) {
          score = __fdiv_rn(__fadd_rn(fit_score(av, nu), aff_term), divisor);
        } else {
          float cl[kDims];
          bool over = false;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            cl[d] = fminf(nu[d], av[d]);
            over = over || (nu[d] > av[d]);
          }
          const float num =
              __fadd_rn(__fadd_rn(fit_score(av, cl), aff_term),
                        over ? preempt_score(npr_s[i]) : 0.0f);
          score = __fdiv_rn(num, __fadd_rn(divisor, over ? 1.0f : 0.0f));
        }
        const float bid = __fsub_rn(__fadd_rn(score, jit_g[i]), price[i]);
        topr_insert(lst, bid_key(bid, i));
      }
    }
    warp_topr(lst, cand[row][warp & 1]);
  }
  __syncthreads();

  // merge each row's two halves into the staged pool
  if (tid < g) {
    const int row = tid;
    const uint64_t* x = cand[row][0];
    const uint64_t* y = cand[row][1];
    int ix = 0, iy = 0;
    for (int j = 0; j < rl; ++j) {
      uint64_t key;
      if (x[ix] >= y[iy]) {
        key = x[ix++];
      } else {
        key = y[iy++];
      }
      float v = kNeg, cap = 0.0f, gid = (float)(-1 - (s * rl + j));
      if (key != 0) {
        const int li = key_idx(key);
        v = key_val(key);
        float per = INFINITY;
#pragma unroll
        for (int d = 0; d < kDims; ++d) {
          const float a_d = s_ask[row][d];
          if (a_d > 0.0f) {
            const float av = av_s[li * kDims + d];
            const float cap_d =
                has_evict ? __fadd_rn(av, ev_s[li * kDims + d]) : av;
            per = fminf(per, floorf(__fdiv_rn(
                                 __fsub_rn(cap_d, used[li * kDims + d]), a_d)));
          }
        }
        cap = fmaxf(per, 0.0f);
        gid = (float)(lo + li);
      }
      stage[(0 * g + row) * rl + j] = v;
      stage[(1 * g + row) * rl + j] = cap;
      stage[(2 * g + row) * rl + j] = gid;
    }
  }
  __syncthreads();
  const int w = 3 * g * rl;
  const long long at =
      a.lay.pools + (((long long)par * a.n_t + t) * a.shards + s) * w;
  for (int d = 0; d < a.shards; ++d) {
    float* dst = reinterpret_cast<float*>(a.scratch[d] + at);
    for (int i = tid; i < w; i += kThreads) dst[i] = stage[i];
  }
}

// the round's merge (sharding.py:488-541) over restart t's gathered pools
// in the team's first shard's buffer, the same on every CTA of the group:
// each row's exact global top rg, winners, fills and price bumps, applied
// to the team's own rows. Returns whether any eval placed.
__device__ int joint_merge(const ShardArgs& a, const Team& team, int t,
                           int par, int* s_rem, const float (*s_ask)[kDims],
                           uint64_t* smem) {
  __shared__ int s_progress;
  const int S = a.shards, g = a.g, rl = a.rl, rg = a.rg, n_loc = a.n_loc;
  const int tid = threadIdx.x;
  const int w = 3 * g * rl;
  const float* pools = reinterpret_cast<const float*>(
      a.scratch[team.my[0]] + a.lay.pools +
      ((long long)par * a.n_t + t) * S * w);
  const int m = S * rl;         // entries of a row
  const int n_all = g * m;
  const int n_ent = g * rg;
  uint64_t* mkey = smem;        // g x S x rl
  float* e_val = reinterpret_cast<float*>(mkey + n_all);
  float* e_cap = e_val + n_ent;
  int* e_gid = reinterpret_cast<int*>(e_cap + n_ent);
  int* e_amt = e_gid + n_ent;
  int* e_bids = e_amt + n_ent;
  if (tid == 0) s_progress = 0;
  // entry (row, j) of shard q: pools[q][.][row][j]
  for (int x = tid; x < n_all; x += kThreads) {
    const int row = x / m;
    const int j = x % m;
    const float* pool = pools + (long long)(j / rl) * w;
    const int i = row * rl + j % rl;
    mkey[x] = merge_key(load_cg(pool + i), load_cg(pool + 2 * g * rl + i));
  }
  __syncthreads();
  // each row's exact global top rg: an entry's rank among its row's keys
  for (int x = tid; x < n_all; x += kThreads) {
    const int row = x / m;
    const uint64_t key = mkey[x];
    int rank = 0;
    for (int y = row * m; y < (row + 1) * m; ++y) rank += mkey[y] < key;
    if (rank < rg) {
      const int j = x % m;
      const float* pool = pools + (long long)(j / rl) * w;
      const int i = row * rl + j % rl;
      const int e = row * rg + rank;
      e_val[e] = load_cg(pool + i);
      e_cap[e] = load_cg(pool + g * rl + i);
      e_gid[e] = (int)load_cg(pool + 2 * g * rl + i);
    }
  }
  __syncthreads();

  // winners (each node to its best bid, ties to the lowest eval) and bids
  // per node, over the active entries (value > NEG / 2)
  for (int x = tid; x < n_ent; x += kThreads) {
    const float v = e_val[x];
    const int gid = e_gid[x];
    const int ge = x / rg;
    int bids = 0;
    float cap = 0.0f;
    if (v > kNeg / 2) {
      bool won = true;
      for (int o = 0; o < n_ent; ++o) {
        if (e_gid[o] != gid || !(e_val[o] > kNeg / 2)) continue;
        ++bids;
        const float vo = e_val[o];
        if (vo > v || (vo == v && o / rg < ge)) won = false;
      }
      if (won) cap = e_cap[x];
    }
    e_bids[x] = bids;
    e_amt[x] = 0;
    e_cap[x] = cap;  // now the won capacity, 0 where not won
  }
  __syncthreads();

  // each row spends its demand over its won nodes in score order:
  // amt = clip(remaining - (cumsum(cap) - cap), 0, cap), NaN -> 0
  if (tid < g) {
    const float rem_f = (float)s_rem[tid];
    float cum = 0.0f;
    int total = 0;
    for (int j = 0; j < rg; ++j) {
      const int x = tid * rg + j;
      const float c = e_cap[x];
      cum = __fadd_rn(cum, c);
      const float y = __fsub_rn(rem_f, __fsub_rn(cum, c));
      const int amt = (int)fminf(fmaxf(y, 0.0f), c);
      e_amt[x] = amt;
      total += amt;
    }
    s_rem[tid] -= total;
    if (total > 0) s_progress = 1;
  }
  __syncthreads();

  // the team's own rows: usage, take, and the price of contested, drained
  // nodes (one winner per node, so no two threads touch one row)
  const float eps = a.eps[t];
  for (int x = tid; x < n_ent; x += kThreads) {
    const int gid = e_gid[x];
    if (gid < 0 || !team.mine[gid / n_loc]) continue;
    const int owner = gid / n_loc;
    const int pos = gid - owner * n_loc;
    int* sc = a.scratch[owner];
    float* used = reinterpret_cast<float*>(sc + a.lay.used_t) +
                  (long long)t * n_loc * kDims;
    int* take = sc + a.lay.take_t + (long long)t * g * n_loc;
    float* price =
        reinterpret_cast<float*>(sc + a.lay.price_t) + (long long)t * n_loc;
    const int amt = e_amt[x];
    const int row = x / rg;
    if (amt > 0) {
      const float af = (float)amt;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        used[pos * kDims + d] = __fadd_rn(
            used[pos * kDims + d], __fmul_rn(s_ask[row][d], af));
      }
      take[(long long)row * n_loc + pos] += amt;
    }
    const float cap = e_cap[x];
    if (cap > 0.0f && (float)amt >= cap && e_bids[x] > 1) {
      price[pos] = __fadd_rn(price[pos], eps);
    }
  }
  __syncthreads();
  const int progress = s_progress;
  __syncthreads();
  return progress;
}

// restart t's rounds for the team's shards: a group barrier a round. The
// owner of shard 0 writes the rounds run.
__device__ void restart_loop(const ShardArgs& a, const Team& team, int t,
                             unsigned* words, uint64_t* smem) {
  __shared__ int s_rem[kMaxG];
  __shared__ float s_ask[kMaxG][kDims];
  __shared__ uint32_t s_key[kMaxG][2];
  __shared__ int s_go;
  const int g = a.g, n_loc = a.n_loc;
  const int tid = threadIdx.x;
  if (tid < g) {
    s_rem[tid] = a.k[tid];
#pragma unroll
    for (int d = 0; d < kDims; ++d) s_ask[tid][d] = a.ask[tid * kDims + d];
    fold_key(a.seeds[tid], (uint32_t)t, s_key[tid][0], s_key[tid][1]);
  }
  __syncthreads();
  for (int i = 0; i < team.n; ++i) {
    const int s = team.my[i];
    const int lo = s * n_loc;
    int* sc = a.scratch[s];
    float* used = reinterpret_cast<float*>(sc + a.lay.used_t) +
                  (long long)t * n_loc * kDims;
    int* take = sc + a.lay.take_t + (long long)t * g * n_loc;
    float* price =
        reinterpret_cast<float*>(sc + a.lay.price_t) + (long long)t * n_loc;
    float* jit = reinterpret_cast<float*>(sc + a.lay.jit_t) +
                 (long long)t * g * n_loc;
    const float* used0 = a.used[s];
    for (int x = tid; x < n_loc * kDims; x += kThreads) used[x] = used0[x];
    for (int x = tid; x < n_loc; x += kThreads) price[x] = 0.0f;
    for (long long x = tid; x < (long long)g * n_loc; x += kThreads) {
      const int row = (int)(x / n_loc);
      const int node = (int)(x - (long long)row * n_loc);
      take[x] = 0;
      jit[x] = bits_to_unit(threefry_bits(s_key[row][0], s_key[row][1], 0u,
                                          (uint32_t)(lo + node)),
                            a.spans[t]);
    }
  }
  if (tid == 0) {
    int any = 0;
    for (int e = 0; e < g; ++e) any |= a.k[e] > 0;
    s_go = any && a.rounds_cap > 0;
  }
  __syncthreads();
  uint64_t* cand = smem;
  float* stage = reinterpret_cast<float*>(cand + (long long)g * 2 * kTopR);
  int rnd = 0;
  while (s_go) {
    const int par = rnd & 1;
    for (int i = 0; i < team.n; ++i) {
      joint_bids(a, t, team.my[i], par, s_rem, s_ask, cand, stage);
    }
    group_sync(words, a.group_ctas, a.cross);
    const int progress = joint_merge(a, team, t, par, s_rem, s_ask, smem);
    ++rnd;
    if (tid == 0) {
      int any = 0;
      for (int e = 0; e < g; ++e) any |= s_rem[e] > 0;
      s_go = rnd < a.rounds_cap && progress && any;
    }
    __syncthreads();
  }
  if (team.mine[0] && tid == 0) a.scratch[0][a.lay.rounds_t + t] = rnd;
}

// the team's arm contributions (arm < T a restart, arm T the greedy arm):
// per node placed x fitness of its final usage, and the placed total,
// pushed into every shard's buffers
__device__ void joint_contrib(const ShardArgs& a, const Team& team, int arm) {
  __shared__ int s_placed;
  const int g = a.g, n_loc = a.n_loc, n_t = a.n_t;
  const bool greedy = arm == n_t;
  for (int k = 0; k < team.n; ++k) {
    const int s = team.my[k];
    const int* sc = a.scratch[s];
    const float* used =
        greedy ? reinterpret_cast<const float*>(sc + a.lay.used_g)
               : reinterpret_cast<const float*>(sc + a.lay.used_t) +
                     (long long)arm * n_loc * kDims;
    const int16_t* counts_g =
        reinterpret_cast<const int16_t*>(sc + a.lay.counts_g);
    const int* take = sc + a.lay.take_t + (long long)arm * g * n_loc;
    const float* av = a.avail[s];
    const long long at = a.lay.contrib + ((long long)s * (n_t + 1) + arm) * n_loc;
    if (threadIdx.x == 0) s_placed = 0;
    __syncthreads();
    int local = 0;
    for (int i = threadIdx.x; i < n_loc; i += kThreads) {
      int c = 0;
      for (int row = 0; row < g; ++row) {
        const long long x = (long long)row * n_loc + i;
        c += greedy ? (int)counts_g[x] : take[x];
      }
      const float v = __fmul_rn((float)c, fit_score(av + i * kDims,
                                                    used + i * kDims));
      for (int d = 0; d < a.shards; ++d) {
        reinterpret_cast<float*>(a.scratch[d] + at)[i] = v;
      }
      local += c;
    }
    if (local) atomicAdd(&s_placed, local);
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int d = 0; d < a.shards; ++d) {
        a.scratch[d][a.lay.placed + (long long)s * (n_t + 1) + arm] = s_placed;
      }
    }
    __syncthreads();
  }
}

// the arm scores over the gathered contributions in the global node order
// (the pairwise tree) and the pick as solve_batch makes it, the same on
// every team; each copies its own rows of the chosen arm. The owner of
// shard 0 writes the info row and the gather count.
__device__ void joint_pick(const ShardArgs& a, const Team& team,
                           float* tree) {
  const int g = a.g, n_loc = a.n_loc, n_t = a.n_t, S = a.shards;
  const int n = S * n_loc;
  const int p = pow2_at_least(n);
  const int* sc0 = a.scratch[team.my[0]];
  const float* contrib = reinterpret_cast<const float*>(sc0 + a.lay.contrib);
  const int* placed = sc0 + a.lay.placed;
  // the tree over chunks of at most kTreeChunk nodes in shared memory,
  // then over the chunks' sums by the same halving (an aligned chunk's
  // share of the padded tree is the chunk's own tree)
  __shared__ float chunk_sum[kMaxTree / kTreeChunk];
  const int chunk = p < kTreeChunk ? p : kTreeChunk;
  int best_t = 0, best_placed = 0, placed_g = 0;
  float best_score = 0.0f, score_g = 0.0f;
  for (int arm = 0; arm <= n_t; ++arm) {
    for (int c = 0; c < p / chunk; ++c) {
      for (int q = threadIdx.x; q < chunk; q += kThreads) {
        const int j = c * chunk + q;
        tree[q] = j < n ? load_cg(contrib +
                                  ((long long)(j / n_loc) * (n_t + 1) + arm) *
                                      n_loc + j % n_loc)
                        : 0.0f;
      }
      __syncthreads();
      const float part =
          block_pairwise_sum<kThreads, kTreeChunk / 2 / kThreads>(tree,
                                                                  chunk);
      if (threadIdx.x == 0) chunk_sum[c] = part;
    }
    if (threadIdx.x == 0) {
      for (int m = p / chunk; m > 1; m >>= 1) {
        for (int i = 0; i < m / 2; ++i) {
          chunk_sum[i] = __fadd_rn(chunk_sum[2 * i], chunk_sum[2 * i + 1]);
        }
      }
    }
    __syncthreads();
    const float score = chunk_sum[0];
    __syncthreads();  // chunk_sum is the next arm's
    int pl = 0;
    for (int q = 0; q < S; ++q) pl += load_cg(placed + q * (n_t + 1) + arm);
    if (arm == n_t) {
      score_g = score;
      placed_g = pl;
    } else if (arm == 0 || pl > best_placed ||
               (pl == best_placed && score > best_score)) {
      best_t = arm;
      best_score = score;
      best_placed = pl;
    }
  }
  const bool pick_a = best_placed > placed_g ||
                      (best_placed == placed_g && best_score > score_g);
  for (int k = 0; k < team.n; ++k) {
    const int s = team.my[k];
    const int* sc = a.scratch[s];
    const float* src =
        pick_a ? reinterpret_cast<const float*>(sc + a.lay.used_t) +
                     (long long)best_t * n_loc * kDims
               : reinterpret_cast<const float*>(sc + a.lay.used_g);
    const int* take = sc + a.lay.take_t + (long long)best_t * g * n_loc;
    const int16_t* counts_g =
        reinterpret_cast<const int16_t*>(sc + a.lay.counts_g);
    float* used_out = a.used_out[s];
    int16_t* counts_out = a.counts[s];
    for (int i = threadIdx.x; i < n_loc * kDims; i += kThreads) {
      used_out[i] = src[i];
    }
    for (long long x = threadIdx.x; x < (long long)g * n_loc; x += kThreads) {
      counts_out[x] = pick_a ? (int16_t)take[x] : counts_g[x];
    }
  }
  if (team.mine[0] && threadIdx.x == 0) {
    const int* sc = a.scratch[0];
    int gat = 1;
    for (int e = 0; e < g; ++e) gat += sc[a.lay.rounds_g + e];
    for (int t = 0; t < n_t; ++t) gat += load_cg(sc + a.lay.rounds_t + t) + 1;
    *a.gathers = gat;
    a.info[0] = best_score;
    a.info[1] = score_g;
    a.info[2] = (float)best_placed;
    a.info[3] = (float)placed_g;
    a.info[4] = (float)load_cg(sc + a.lay.rounds_t + best_t);
    a.info[5] = pick_a ? 1.0f : 0.0f;
  }
}

// blockIdx.x = arm x ctas_here + j: arm < T restart arm, arm T the greedy
// arm; the barrier words: group 0 all CTAs, 1 the greedy arm's, 2 + t
// restart t's
__global__ void __launch_bounds__(kThreads, 1)
joint_solve_kernel(const __grid_constant__ ShardArgs a) {
  extern __shared__ uint64_t smem[];
  __shared__ int warp_tot[32];
  __shared__ Team team;
  const int arm = blockIdx.x / a.ctas_here;
  team_init(a, blockIdx.x % a.ctas_here, team);
  unsigned* all = group_words(a, 0);
  const int all_ctas = (a.n_t + 1) * a.group_ctas;
  if (a.cross) group_sync(all, all_ctas, true);
  if (arm == a.n_t) {
    for (int k = 0; k < team.n; ++k) {
      const int s = team.my[k];
      const float* u0 = a.used[s];
      float* ug = reinterpret_cast<float*>(a.scratch[s] + a.lay.used_g);
      for (int x = threadIdx.x; x < a.n_loc * kDims; x += kThreads) {
        ug[x] = u0[x];
      }
    }
    __syncthreads();
    fill_loop(a, team, group_words(a, 1), smem, warp_tot);
  } else {
    restart_loop(a, team, arm, group_words(a, 2 + arm), smem);
  }
  joint_contrib(a, team, arm);
  group_sync(all, all_ctas, a.cross);
  if (arm == a.n_t) joint_pick(a, team, reinterpret_cast<float*>(smem));
  if (a.cross) group_sync(all, all_ctas, true);
}

// ---------------------------------------------------------------------------
// the barrier probe: CTA b writes round + 1 into out[round & 1][b], a
// barrier, then reads every CTA's word of that parity; a word that is not
// round + 1 counts into out[2 x ctas]. With fewer CTAs than participants
// the first barrier never completes and the launch traps.
// ---------------------------------------------------------------------------

__global__ void barrier_probe_kernel(unsigned* words, int* out, int ctas,
                                     int participants, int rounds,
                                     long long timeout_ns) {
  for (int rnd = 0; rnd < rounds; ++rnd) {
    int* slot = out + (rnd & 1) * ctas;
    if (threadIdx.x == 0) slot[blockIdx.x] = rnd + 1;
    __syncthreads();
    if (threadIdx.x == 0) {
      nt_mesh::group_arrive_wait<cuda::thread_scope_device>(
          words, participants, timeout_ns);
    }
    __syncthreads();
    int bad = 0;
    for (int q = threadIdx.x; q < ctas; q += blockDim.x) {
      bad += load_cg(slot + q) != rnd + 1;
    }
    if (bad) atomicAdd(out + 2 * ctas, bad);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B15: used[idx] += delta on the shard's own rows, then (clamp) max(., 0)
// ---------------------------------------------------------------------------
//
// Without the clamp, one thread per (row, dim) over as many CTAs as the
// rows need, as B4: a twin flush of thousands of rows fills the card. With
// it (the B13/B14 correction fold), one CTA a shard: every add has landed
// (__syncthreads) before the clamp of all the shard's rows, 16 bytes a
// thread.

__global__ void scatter_shard_kernel(float* __restrict__ used,
                                     const int* __restrict__ idx,
                                     const float* __restrict__ delta, int b,
                                     int n_loc, int s) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= b * kDims) return;
  const int row = idx[t / kDims] - s * n_loc;
  if (row < 0 || row >= n_loc) return;  // another shard's row
  atomicAdd(&used[(long long)row * kDims + t % kDims], delta[t]);
}

__global__ void scatter_clamp_shard_kernel(float* __restrict__ used,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ delta,
                                           int b, int n_loc, int s) {
  const int lo = s * n_loc;
  for (int t = threadIdx.x; t < b * kDims; t += blockDim.x) {
    const int row = idx[t / kDims] - lo;
    if (row < 0 || row >= n_loc) continue;
    atomicAdd(&used[(long long)row * kDims + t % kDims], delta[t]);
  }
  __syncthreads();
  float4* rows = reinterpret_cast<float4*>(used);
  for (int r = threadIdx.x; r < n_loc; r += blockDim.x) {
    float4 v = rows[r];
    v.x = fmaxf(v.x, 0.0f);
    v.y = fmaxf(v.y, 0.0f);
    v.z = fmaxf(v.z, 0.0f);
    v.w = fmaxf(v.w, 0.0f);
    rows[r] = v;
  }
}

// ---------------------------------------------------------------------------
// host side of the mesh launches
// ---------------------------------------------------------------------------

// One cooperative launch of ``kernel`` on each card: grid arms x (the
// card's CTAs of one group), each CTA per_cta of the card's shards, per_cta
// the least that lets every card hold its grid at once. ``args`` holds the
// shards' pointers; each card's copy gets its shards and replicated inputs.
// One host thread at a time makes a mesh's launches (ctypes lets host
// calls overlap): two solves whose launches reached two cards in opposite
// orders would each wait on the other's barrier.
template <typename Kernel>
cudaError_t launch_mesh(Kernel kernel, ShardArgs& args, int arms,
                        size_t smem, const int* shard_card,
                        const int* ordinals, int cards,
                        const void* const* ask, const void* const* k,
                        const void* const* seeds, void* const* streams) {
  static std::mutex launching;
  const std::lock_guard<std::mutex> hold(launching);
  if (cards < 1 || cards > kMaxCards || cards > args.shards)
    return cudaErrorInvalidValue;
  for (int c = 0; c < cards; ++c) {
    if (ordinals[c] < 0 || ordinals[c] >= kMaxCards)
      return cudaErrorInvalidValue;
  }
  int count[kMaxCards] = {0};
  for (int s = 0; s < args.shards; ++s) {
    if (shard_card[s] < 0 || shard_card[s] >= cards)
      return cudaErrorInvalidValue;
    ++count[shard_card[s]];
  }
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return err;
  if (cards > 1) err = nt_mesh::enable_peers(ordinals, cards);
  long long capacity[kMaxCards];
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    err = cudaSetDevice(ordinals[c]);
    int optin = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, ordinals[c]);
    if (err == cudaSuccess && smem > (size_t)optin)
      err = cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   ordinals[c]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    capacity[c] = (long long)per_sm * sms;
    if (err == cudaSuccess && capacity[c] < arms)
      err = cudaErrorCooperativeLaunchTooLarge;
  }
  int per = 1;
  for (bool fits = false; err == cudaSuccess && !fits; ) {
    fits = true;
    for (int c = 0; c < cards; ++c) {
      fits = fits && (long long)arms * ((count[c] + per - 1) / per) <=
                         capacity[c];
    }
    if (!fits) ++per;
  }
  int group = 0;
  for (int c = 0; c < cards; ++c) group += (count[c] + per - 1) / per;
  args.per_cta = per;
  args.group_ctas = group;
  args.cross = cards > 1;
  for (int c = 0; c < cards && err == cudaSuccess; ++c) {
    int n = 0;
    for (int s = 0; s < args.shards; ++s) {
      if (shard_card[s] == c) args.card_shards[n++] = s;
    }
    args.n_card = n;
    args.ctas_here = (n + per - 1) / per;
    args.ask = (const float*)ask[c];
    args.k = (const int*)k[c];
    args.seeds = (const long long*)seeds[c];
    err = cudaSetDevice(ordinals[c]);
    if (err != cudaSuccess) break;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel((const void*)kernel,
                                      dim3(arms * args.ctas_here),
                                      dim3(kThreads), params, smem,
                                      (cudaStream_t)streams[c]);
  }
  const cudaError_t back = cudaSetDevice(caller);
  if (err == cudaSuccess) err = back;
  return err;
}

// B13's dynamic shared memory: the eval's sort of a shard's live keys up
// to kSortNodes (above, a round's chosen pool and its stage), the merge,
// the stage
size_t bulk_smem(int n_loc, int shards, int r) {
  const int pm = pow2_at_least(shards * r);
  size_t bytes = n_loc <= kSortNodes
                     ? (size_t)pow2_at_least(n_loc) * sizeof(uint64_t)
                     : (size_t)pow2_at_least(r) * sizeof(uint64_t) +
                           (size_t)3 * r * sizeof(float);
  const size_t merge = (size_t)pm * (sizeof(uint64_t) + 3 * sizeof(int));
  if (merge > bytes) bytes = merge;
  if ((size_t)3 * r * sizeof(float) > bytes) bytes = 3 * r * sizeof(float);
  return bytes;
}

}  // namespace

// B15 for all S shards from one host call: shard s's launch on card
// ordinals[s] and streams[s], that card made current only when it is not,
// the caller's device current again at the end. Returns the first error.
extern "C" int nt_scatter_shards(void* const* used, const void* const* idx,
                                 const void* const* delta,
                                 const int* ordinals, int shards, int b,
                                 int n_loc, int clamp,
                                 void* const* streams) {
  if (shards < 1 || n_loc < 1 || b < 0) return (int)cudaErrorInvalidValue;
  int caller = 0;
  cudaError_t err = cudaGetDevice(&caller);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  int cur = caller;
  for (int s = 0; s < shards && err == cudaSuccess; ++s) {
    if (ordinals[s] != cur) {
      err = cudaSetDevice(ordinals[s]);
      if (err != cudaSuccess) break;
      cur = ordinals[s];
    }
    const cudaStream_t stream = (cudaStream_t)streams[s];
    if (clamp) {
      scatter_clamp_shard_kernel<<<1, threads, 0, stream>>>(
          (float*)used[s], (const int*)idx[s], (const float*)delta[s], b,
          n_loc, s);
    } else if (b > 0) {
      scatter_shard_kernel<<<(b * kDims + threads - 1) / threads, threads, 0,
                             stream>>>(
          (float*)used[s], (const int*)idx[s], (const float*)delta[s], b,
          n_loc, s);
    }
    err = cudaGetLastError();
  }
  if (cur != caller) {
    const cudaError_t back = cudaSetDevice(caller);
    if (err == cudaSuccess) err = back;
  }
  return (int)err;
}

extern "C" long long nt_bulk_shard_solve_scratch_words(int g, int n_loc,
                                                      int shards, int r) {
  (void)g;
  return bulk_layout(n_loc, shards, r).words;
}

// B13: G chained greedy fills on the mesh, one launch a card. Arrays of
// S: used (the carry, in place), avail, feas, aff, counts (out) and scratch
// (nt_bulk_shard_solve_scratch_words each); arrays of ``cards``: each
// card's copy of ask, k and seeds (int64); rounds (G,) and the barrier
// words on shard 0's card.
extern "C" int nt_bulk_shard_solve(void* const* used, const void* const* avail,
                                   const void* const* feas,
                                   const void* const* aff,
                                   void* const* counts, void* const* scratch,
                                   const void* const* ask,
                                   const void* const* k,
                                   const void* const* seeds, void* rounds,
                                   void* barrier, const int* shard_card,
                                   const int* ordinals, int cards,
                                   int shards, int g, int n_loc, int r,
                                   float span, void* const* streams) {
  if (shards < 1 || shards > kMaxShards || g < 1 || n_loc < 1 ||
      n_loc > kMaxFillNodes || r < 1 || r > n_loc ||
      shards * r > kMaxMerge)
    return (int)cudaErrorInvalidValue;
  ShardArgs args{};
  for (int s = 0; s < shards; ++s) {
    args.used[s] = (float*)used[s];
    args.avail[s] = (const float*)avail[s];
    args.feas[s] = (const uint8_t*)feas[s];
    args.aff[s] = (const float*)aff[s];
    args.counts[s] = (int16_t*)counts[s];
    args.scratch[s] = (int*)scratch[s];
  }
  args.rounds = (int*)rounds;
  args.barrier = (unsigned*)barrier;
  args.lay.bulk = bulk_layout(n_loc, shards, r);
  args.span = span;
  args.g = g;
  args.n_loc = n_loc;
  args.shards = shards;
  args.r = r;
  args.joint = 0;
  return (int)launch_mesh(bulk_solve_kernel, args, 1,
                          bulk_smem(n_loc, shards, r), shard_card, ordinals,
                          cards, ask, k, seeds, streams);
}

extern "C" long long nt_joint_shard_solve_scratch_words(int g, int n_loc,
                                                       int shards, int r,
                                                       int rl, int n_t) {
  return joint_layout(g, n_loc, shards, r, rl, n_t).words;
}

// B14: the greedy arm (B13) and the T auction restarts at once, the arm
// scores and the pick, one launch a card. Arrays of S: used (the folded
// carry, read), avail, feas, aff, evict and net_prio (or a null array),
// used_out and counts (out), scratch (nt_joint_shard_solve_scratch_words
// each); arrays of ``cards``: each card's ask, k and seeds; info (6,),
// gathers and the barrier words on shard 0's card. consts: the greedy
// jitter width, then T restart widths, then T price temperatures.
extern "C" int nt_joint_shard_solve(
    const void* const* used, const void* const* avail,
    const void* const* feas, const void* const* aff,
    const void* const* evict, const void* const* net_prio,
    void* const* used_out, void* const* counts, void* const* scratch,
    const void* const* ask, const void* const* k, const void* const* seeds,
    void* info, void* gathers, void* barrier, const int* shard_card,
    const int* ordinals, const float* consts, int cards, int shards, int g,
    int n_loc, int r, int rl, int rg, int n_t, int rounds_cap,
    void* const* streams) {
  if (shards < 1 || shards > kMaxShards || g < 1 || g > kMaxG || n_loc < 1 ||
      n_loc > kMaxFillNodes || r < 1 || r > n_loc || shards * r > kMaxMerge ||
      n_t < 1 || n_t > kMaxRestarts || rl < 1 || rl > kTopR || rl > n_loc ||
      rg < 1 || rg > kTopR || g * rg > kMaxJoint || rg > shards * rl ||
      (long long)shards * n_loc > kMaxTree)
    return (int)cudaErrorInvalidValue;
  ShardArgs args{};
  for (int s = 0; s < shards; ++s) {
    args.used[s] = (float*)used[s];
    args.avail[s] = (const float*)avail[s];
    args.feas[s] = (const uint8_t*)feas[s];
    args.aff[s] = (const float*)aff[s];
    args.evict[s] = evict ? (const float*)evict[s] : nullptr;
    args.net_prio[s] = net_prio ? (const float*)net_prio[s] : nullptr;
    args.used_out[s] = (float*)used_out[s];
    args.counts[s] = (int16_t*)counts[s];
    args.scratch[s] = (int*)scratch[s];
  }
  args.info = (float*)info;
  args.gathers = (int*)gathers;
  args.barrier = (unsigned*)barrier;
  args.lay = joint_layout(g, n_loc, shards, r, rl, n_t);
  args.span = consts[0];
  for (int t = 0; t < n_t; ++t) {
    args.spans[t] = consts[1 + t];
    args.eps[t] = consts[1 + n_t + t];
  }
  args.g = g;
  args.n_loc = n_loc;
  args.shards = shards;
  args.r = r;
  args.rl = rl;
  args.rg = rg;
  args.n_t = n_t;
  args.rounds_cap = rounds_cap;
  args.joint = 1;
  size_t smem = bulk_smem(n_loc, shards, r);
  const size_t bids = (size_t)g * 2 * kTopR * sizeof(uint64_t) +
                      (size_t)3 * g * rl * sizeof(float);
  const size_t merge = (size_t)g * shards * rl * sizeof(uint64_t) +
                       (size_t)5 * g * rg * sizeof(int);
  const int pad = pow2_at_least(shards * n_loc);
  const size_t tree = (size_t)(pad < kTreeChunk ? pad : kTreeChunk) *
                      sizeof(float);
  if (bids > smem) smem = bids;
  if (merge > smem) smem = merge;
  if (tree > smem) smem = tree;
  return (int)launch_mesh(joint_solve_kernel, args, n_t + 1, smem,
                          shard_card, ordinals, cards, ask, k, seeds,
                          streams);
}

// The barrier probe: ``ctas`` CTAs of 128 threads in one cooperative
// launch, ``rounds`` barriers of ``participants`` over the words (two,
// zeroed); out (2 x ctas + 1) int32, its last word the count of stale
// reads. participants > ctas never completes: the launch traps after
// timeout_ms.
extern "C" int nt_mesh_barrier_probe(void* words, void* out, int ctas,
                                     int participants, int rounds,
                                     int timeout_ms, void* stream) {
  if (ctas < 1 || participants < 1 || rounds < 0 || timeout_ms < 1)
    return (int)cudaErrorInvalidValue;
  unsigned* w = (unsigned*)words;
  int* o = (int*)out;
  long long timeout_ns = (long long)timeout_ms * 1000000LL;
  void* params[] = {&w, &o, &ctas, &participants, &rounds, &timeout_ns};
  return (int)cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel,
                                          dim3(ctas), dim3(128), params, 0,
                                          (cudaStream_t)stream);
}
