// B5 (nt_auction) and the pick of B6 (nt_batch_pick): the joint solve of
// SchedulerAlgorithm="tpu-solve".
//
// Replaces: _auction (nomad_tpu/tensor/batch_solver.py:137-253) with its
// five PORTFOLIO restarts and their fold_in jitter (:319-323, B3', drawn
// here), and the packing scores, restart chain and auction-vs-greedy pick
// of solve_batch (:256-358, with _packing_score_xp :121-126 and
// kernels._pairwise_sum_xp kernels.py:91-110). The rest of solve_batch
// runs as the port's other kernels on the same stream: the correction fold
// (scatter.cu) and the greedy arm (bulk_fill.cu).
//
// nt_auction, per restart t, from used = max(used0, 0), price = 0:
//   while rnd < rounds && progressed && any(remaining > 0):
//     bid[g,n] = score(g,n) + jit[t,g,n] - price[n] where feasible, fitting
//                (within avail + evict) and remaining[g] > 0, else NEG
//     each row's R=16 best bids in XLA top_k order (bid desc, -0.0 below
//     +0.0, node index asc); each node goes to its highest bid, residual
//     ties (IEEE ==) to the lowest eval
//     each winner fills its won nodes in that order from its remaining
//     demand (cap = floor(free / ask), free read before the round's update)
//     price[n] += eps[t] on nodes that were both contested and drained
// With evict, fitness is taken at min(used + ask, avail) and over-capacity
// bids add the logistic preemption score of net_prio and divide by one more.
// jit[t,g,n] is U[0, hi_t) from fold_in(PRNGKey(seed_g), t) at node n
// (B3'), drawn where a pair is scored from the row's key, folded once.
//
// Bound on the H100: bytes. The reference's rounds score all G x N pairs
// (two powf each), but a pair's bid moves only when its node's usage or
// price moves, and a round moves at most G x R nodes.
//
// Design: per-row candidate lists. A row's nodes belong to 64 home lanes
// (node n to lane (n >> 4) & 63); each (row, lane) keeps a sorted list of
// up to kDepth = R keys (topr.cuh's bid_key: top_k's order, unique per
// node) and a floor. Invariant: every fitting home node outside the list
// has a current key below the floor; every entry holds its node's current
// key.
//   - A scan scores every node of a row with all 1024 threads of a CTA,
//     each keeping its keys (at most 16) in registers; the 16 threads of a
//     lane (a half-warp) merge theirs into its list, and the floor goes
//     just above the best key left out.
//   - After a round, each row with demand left drops the nodes the round
//     touched (usage moved; a price moves only where usage did) from its
//     lists, rescores them and inserts each key at or above its lane's
//     floor; a full list evicts its smallest key and raises the floor just
//     above it.
//   - A row's top R is the top R of its lists (one warp a row) whenever its
//     R-th key is at or above every lane's floor; otherwise the row is
//     scanned again (after a scan it always is: a list holds R keys).
// One cooperative launch of T x C CTAs (C at most G, as many as the card
// holds at once): every CTA initialises a slice of its restart's carry,
// prices and takes and scans the first round of rows c, c + C, ... into a
// global scratch; after one barrier (mesh.cuh) CTA 0 of each restart runs
// its rounds alone, side by side with the others, its lists copied into
// dynamic shared memory where they fit (else read in the scratch, L2).
// The round's resolution never leaves the CTA: the <= G x R surfaced
// entries live in shared memory; a node's best bid and bid count come from
// a table of the surfaced nodes (shared atomics), then caps, the row fill
// and the price bumps; the only global writes of a round are the winners'
// usage, take and price cells. The loop condition is computed in shared
// memory, so the host never syncs between rounds.
//
// nt_batch_pick scores the T restarts and the greedy arm (placed per node
// times the BestFit fitness of the final usage, summed by the reference's
// padded pairwise tree), keeps the best restart by (placed, score) with the
// earliest winning exact ties, picks it against the greedy arm the same way
// and writes the chosen carry, the int16 counts and the info row
// [auction_score, greedy_score, placed_auction, placed_greedy, rounds_run,
// auction_won].
//
// Bound on the H100: bytes (the T takes, a read of G int32 a node each,
// are most of them). The reference's tree pads to a power of two p and
// halves by v[0::2] + v[1::2], so its value at level k over an aligned
// chunk [c 2^k, (c + 1) 2^k) is the pairwise tree of that chunk alone, and
// the whole sum is the same tree over the chunk sums in chunk order, bit
// for bit. Placed counts are int32 adds, exact in any order.
//
// Design of the pick: one cooperative launch of 256-thread CTAs over the
// (T + 1) x C items (arm, chunk) of 256-1,024 nodes, C = p / chunk, N_pad up
// to 65,536; the chunk is the smallest that keeps the items within 384
// (about three CTAs an SM: the fastest of the three at 4,096-65,536 nodes
// on the H100). Each item reads its arm's G rows of take for its nodes
// coalesced (the greedy arm's int16 counts), forms each node's placed count
// and fitness, multiplies them and reduces the chunk by sort.cuh's
// block_pairwise_sum in shared memory into a scratch of (sum, placed) per
// item. After one mesh.cuh barrier every CTA combines each arm's C chunk
// sums (one warp an arm: a lane's consecutive sums, then shuffles, the same
// halving), runs the restart chain and the pick, and writes its share of
// the chosen carry and counts; CTA 0 writes the info row. (A ticket in
// place of the barrier, the last CTA to arrive combining and writing
// alone, was 6-45x slower on the H100: PERF.md.)
//
// Exactness: no fast math (built with --fmad=false), __fadd_rn / __fdiv_rn
// where the reference's order matters, accurate powf and expf, so every
// output equals the plain torch version (tensor/batch_solver.py) on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"
#include "mesh.cuh"
#include "sort.cuh"
#include "threefry.cuh"
#include "topr.cuh"

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = kThreads / nt_topr::kTopR;  // one thread per surfaced entry
constexpr int kMaxEnt = kMaxG * nt_topr::kTopR;
constexpr int kLanes = 64;               // home lanes of a row
constexpr int kRowsAtOnce = kThreads / kLanes;
constexpr int kSub = kThreads / kLanes;  // scan threads of a lane
constexpr int kDepth = nt_topr::kTopR;   // keys a lane's list holds
// a scan thread scores at most R nodes of a row, so its register list
// keeps every one (the caller, solve_batch, pads to at most 16,384)
constexpr int kMaxNodes = kThreads * nt_topr::kTopR;
constexpr int kTouchedBytes = kMaxNodes / 8;
// dynamic shared memory a CTA may take beside its ~31 KB of static arrays
constexpr long long kDynSmem = 176 * 1024;
// B2 and the preemption score: fit.cuh
using nt_fit::fit_score;
using nt_fit::preempt_score;
// the barrier after the first round's scans: mesh.cuh
using nt_mesh::group_sync;
// the restarts' draws: threefry.cuh
using nt_threefry::bits_to_unit;
using nt_threefry::fold_key;
using nt_threefry::threefry_bits;
// top_k's order and the per-lane / per-warp top-R lists: topr.cuh
using nt_topr::bid_key;
using nt_topr::key_idx;
using nt_topr::key_val;
using nt_topr::kTopR;
using nt_topr::topr_insert;
// the reference's fixed pairwise tree: sort.cuh
using nt_sort::block_pairwise_sum;

#ifdef B5_SPLIT
// `chip_smoke.py --b5-split` builds this file with -DB5_SPLIT: thread 0 of
// a restart's round CTA adds up clock64 between the round's barriers into
// b5_split_cycles[t]: slot 6 the first round's scans and set-up, 0-5 the
// first round's phases, 8-13 the later rounds' (B5_STAMP's k below)
__device__ long long b5_split_cycles[16][16];
#define B5_SPLIT_BEGIN \
  long long ph_[16] = {}; \
  long long t_last_ = clock64();
#define B5_STAMP(slot)                  \
  if (threadIdx.x == 0) {               \
    const long long now_ = clock64();   \
    ph_[slot] += now_ - t_last_;        \
    t_last_ = now_;                     \
  }
#define B5_SPLIT_END(t) \
  for (int q = 0; q < 16; ++q) b5_split_cycles[t][q] = ph_[q];
#else
#define B5_SPLIT_BEGIN
#define B5_STAMP(slot)
#define B5_SPLIT_END(t)
#endif

struct AuctionArgs {
  const float* used0;  // (n, 4)
  const float* avail;  // (n, 4)
  const uint8_t* feas;  // (g, n)
  const float* aff;     // (g, n)
  const float* ask;     // (g, 4)
  const int* kk;        // (g,)
  const long long* seeds;  // (g,) PRNGKey seeds
  const float* params;  // (2, T): price temperatures, then jitter widths
  const float* evict;   // (n, 4) or null
  const float* net_prio;  // (n,) or null
  float* used_out;      // (T, n, 4)
  int* take_out;        // (T, g, n)
  int* rounds_out;      // (T,)
  float* price_buf;     // (T, n)
  uint64_t* lists;      // (T, list_words): the first round's scans
  int* scans_out;       // (T,) scans run, or null
  unsigned* barrier;    // a zeroed barrier group (mesh.cuh)
  int n_t, g, n, rounds;
  int scan_ctas;        // CTAs a restart scans its first round on
  int smem_lists;       // a restart keeps its lists in shared memory
};

// a restart's lists: row r's region is (kDepth + 2) x kLanes words, entry
// j of lane l at [j][l] (a warp's lanes on consecutive words), then the
// lanes' floors, then their counts
struct Lists {
  uint64_t* p;
  __device__ uint64_t* at(int row, int j, int l) const {
    return p + ((long long)row * (kDepth + 2) + j) * kLanes + l;
  }
  __device__ uint64_t& floor(int row, int l) const {
    return *at(row, kDepth, l);
  }
  __device__ uint64_t& count(int row, int l) const {
    return *at(row, kDepth + 1, l);
  }
};

__host__ __device__ __forceinline__ long long list_words(int g) {
  return (long long)g * (kDepth + 2) * kLanes;
}

// the slots of the table of a round's surfaced nodes: a power of two, at
// least twice the G x R entries
__host__ __device__ __forceinline__ int hash_slots(int g) {
  int s = 64;
  while (s < 2 * g * nt_topr::kTopR) s <<= 1;
  return s;
}

__device__ __forceinline__ int hash_slot(int idx, int slots) {
  return (int)(((uint32_t)idx * 2654435761u) >> 7) & (slots - 1);
}

// the bid in IEEE order (-0.0 equal to +0.0) over the complement of the
// eval: the largest is the node's best bid, ties to the lowest eval
__device__ __forceinline__ uint64_t best_key(float v, int eval) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)ord << 32) | (uint64_t)(~(uint32_t)eval);
}

__device__ __forceinline__ int home_lane(int i) { return (i >> 4) & 63; }

__device__ __forceinline__ float4 row4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}

// the key of pair (row, i) against the current usage and price, or 0 where
// the node is infeasible or does not fit. kFirst: the first round's, from
// max(used0, 0) at price 0. The loads go out together (one L2 round trip a
// pair: the loop is latency-bound, not bandwidth-bound).
template <bool kFirst>
__device__ __forceinline__ uint64_t pair_key(const AuctionArgs& a,
                                             const float* used,
                                             const float* price, int row,
                                             int i, const float (&a_g)[kDims],
                                             uint32_t k0, uint32_t k1,
                                             float span) {
  const bool has_evict = a.evict != nullptr;
  const bool feasible = a.feas[(long long)row * a.n + i] != 0;
  const float4 v4 = row4(a.avail, i);
  const float4 u4 = row4(used, i);
  const float4 e4 = has_evict ? row4(a.evict, i) : make_float4(0, 0, 0, 0);
  const float af = a.aff[(long long)row * a.n + i];
  const float pr = kFirst ? 0.0f : price[i];
  if (!feasible) return 0;
  const float av[kDims] = {v4.x, v4.y, v4.z, v4.w};
  const float u[kDims] = {kFirst ? fmaxf(u4.x, 0.0f) : u4.x,
                          kFirst ? fmaxf(u4.y, 0.0f) : u4.y,
                          kFirst ? fmaxf(u4.z, 0.0f) : u4.z,
                          kFirst ? fmaxf(u4.w, 0.0f) : u4.w};
  const float ev[kDims] = {e4.x, e4.y, e4.z, e4.w};
  float nu[kDims];
  bool ok = true;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    const float cap_d = has_evict ? __fadd_rn(av[d], ev[d]) : av[d];
    nu[d] = __fadd_rn(u[d], a_g[d]);
    ok = ok && (nu[d] <= cap_d);
  }
  if (!ok) return 0;
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
    const float num = __fadd_rn(__fadd_rn(fit_score(av, cl), aff_term),
                                over ? preempt_score(a.net_prio[i]) : 0.0f);
    score = __fdiv_rn(num, __fadd_rn(divisor, over ? 1.0f : 0.0f));
  }
  const float jit = bits_to_unit(threefry_bits(k0, k1, 0u, (uint32_t)i), span);
  return bid_key(__fsub_rn(__fadd_rn(score, jit), pr), i);
}

__device__ __forceinline__ uint64_t half_max(uint64_t v) {
#pragma unroll
  for (int off = kSub / 2; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// rebuild row's lists from a scan of every node, all threads: thread tid
// scores nodes tid + 1024 j (all of lane tid >> 4: the 16 threads of a lane
// are one half-warp), keeps them sorted (at most R), and the half-warp
// merges them
template <bool kFirst>
__device__ __forceinline__ void scan_row(const AuctionArgs& a,
                                         const Lists& L, const float* used,
                                         const float* price, int row,
                                         const float (&a_g)[kDims],
                                         uint32_t k0, uint32_t k1,
                                         float span) {
  const int tid = threadIdx.x;
  uint64_t lst[kTopR];
#pragma unroll
  for (int i = 0; i < kTopR; ++i) lst[i] = 0;
  for (int i = tid; i < a.n; i += kThreads) {
    const uint64_t key =
        pair_key<kFirst>(a, used, price, row, i, a_g, k0, k1, span);
    if (key != 0) topr_insert(lst, key);
  }
  const int l = tid / kSub;
  uint64_t* dst = L.at(row, 0, l);
  int c = 0;
  for (int j = 0; j < kDepth; ++j) {
    const uint64_t best = half_max(lst[0]);
    if (best != 0) {
      if ((tid & (kSub - 1)) == 0) dst[(long long)j * kLanes] = best;
      if (lst[0] == best) {  // keys are unique: one owner pops
#pragma unroll
        for (int i = 0; i < kTopR - 1; ++i) lst[i] = lst[i + 1];
        lst[kTopR - 1] = 0;
      }
      ++c;
    }
  }
  const uint64_t rest = half_max(lst[0]);
  if ((tid & (kSub - 1)) == 0) {
    L.floor(row, l) = rest ? rest + 1 : 0;
    L.count(row, l) = (uint64_t)c;
  }
}

// insert key into lane l's sorted list (key != 0); a full list evicts its
// smallest key and the floor goes just above the key left out
__device__ __forceinline__ void list_insert(const Lists& L, int row, int l,
                                            uint64_t key, int& c,
                                            uint64_t& fl) {
  if (key < fl) return;
  if (c == kDepth) {
    const uint64_t last = *L.at(row, kDepth - 1, l);
    const uint64_t out = key < last ? key : last;
    fl = out + 1 > fl ? out + 1 : fl;
    if (key < last) return;
    --c;
  }
  int j = c;
  while (j > 0) {
    const uint64_t prev = *L.at(row, j - 1, l);
    if (prev > key) break;
    *L.at(row, j, l) = prev;
    --j;
  }
  *L.at(row, j, l) = key;
  ++c;
}

// a row's R best keys from its lists into out[0, R), one warp a row (lane
// x reads lanes x and x + 32); whether the R-th lies below a lane's floor
// (then the row must be scanned again)
__device__ __forceinline__ bool lists_topr(const Lists& L, int row,
                                           uint64_t* out) {
  const int x = threadIdx.x & 31;
  const int c0 = (int)L.count(row, x), c1 = (int)L.count(row, x + 32);
  const uint64_t* src0 = L.at(row, 0, x);
  const uint64_t* src1 = L.at(row, 0, x + 32);
  int h0 = 0, h1 = 0;
  uint64_t head0 = c0 > 0 ? src0[0] : 0;
  uint64_t head1 = c1 > 0 ? src1[0] : 0;
  uint64_t best = 0;
  for (int j = 0; j < kTopR; ++j) {
    best = warp_max(head0 > head1 ? head0 : head1);
    if (x == 0) out[j] = best;
    if (best == 0) continue;
    if (head0 == best) {  // keys are unique: one list pops
      ++h0;
      head0 = h0 < c0 ? src0[(long long)h0 * kLanes] : 0;
    } else if (head1 == best) {
      ++h1;
      head1 = h1 < c1 ? src1[(long long)h1 * kLanes] : 0;
    }
  }
  const uint64_t f0 = L.floor(row, x), f1 = L.floor(row, x + 32);
  return best < warp_max(f0 > f1 ? f0 : f1);
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const AuctionArgs a) {
  // dynamic: the restart's lists where they fit, the table of a round's
  // surfaced nodes (best keys, nodes, bids), the touched bitmap
  extern __shared__ __align__(16) uint64_t s_dyn[];
  __shared__ uint64_t ent_key[kMaxEnt];
  __shared__ float ent_cap[kMaxEnt];
  __shared__ int ent_amt[kMaxEnt];
  __shared__ int ent_bids[kMaxEnt];
  __shared__ int ent_slot[kMaxEnt];
  __shared__ float s_ask[kMaxG][kDims];
  __shared__ int s_rem[kMaxG];
  __shared__ uint32_t s_key[kMaxG][2];
  __shared__ int s_need[kMaxG];
  __shared__ int s_tnode[kMaxEnt];
  __shared__ int s_tcnt[kLanes];
  __shared__ int s_toff[kLanes + 1];
  __shared__ int s_live;      // a row has demand left
  __shared__ int s_progress;  // the last round placed something
  __shared__ int s_scans;
  B5_SPLIT_BEGIN

  const int t = blockIdx.x / a.scan_ctas;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = a.g, n = a.n;
  const float span = a.params[a.n_t + t];
  const long long words = list_words(g);
  const Lists first{a.lists + t * words};

  // 0. on every CTA, CTA c of restart t: a slice of the restart's carry
  //    (max(used0, 0)), prices (0) and takes (0); the first round's scans
  //    of rows c, c + scan_ctas, ... into the global scratch, from
  //    max(used0, 0) at price 0; then one barrier over the grid
  float* used = a.used_out + (long long)t * n * kDims;
  int* take = a.take_out + (long long)t * g * n;
  float* price = a.price_buf + (long long)t * n;
  {
    const long long first_i =
        (long long)(blockIdx.x % a.scan_ctas) * kThreads + tid;
    const long long stride = (long long)a.scan_ctas * kThreads;
    for (long long i = first_i; i < (long long)n * kDims; i += stride) {
      used[i] = fmaxf(a.used0[i], 0.0f);
    }
    for (long long i = first_i; i < n; i += stride) price[i] = 0.0f;
    for (long long i = first_i; i < (long long)g * n; i += stride) take[i] = 0;
  }
  for (int row = blockIdx.x % a.scan_ctas; row < g; row += a.scan_ctas) {
    if (a.kk[row] <= 0) continue;
    if (tid == 0) {
      fold_key((unsigned long long)a.seeds[row], (uint32_t)t, s_key[0][0],
               s_key[0][1]);
    }
    __syncthreads();
    const float a_g[kDims] = {a.ask[row * kDims], a.ask[row * kDims + 1],
                              a.ask[row * kDims + 2], a.ask[row * kDims + 3]};
    scan_row<true>(a, first, a.used0, nullptr, row, a_g, s_key[0][0],
                   s_key[0][1], span);
    __syncthreads();
  }
  group_sync(a.barrier, a.n_t * a.scan_ctas, false);
  if (blockIdx.x % a.scan_ctas) return;

  // 1. restart t's rounds, on this CTA alone
  const float eps = a.params[t];
  const Lists L{a.smem_lists ? s_dyn : first.p};
  const int slots = hash_slots(g);
  uint64_t* h_best = s_dyn + (a.smem_lists ? words : 0);
  int* h_node = reinterpret_cast<int*>(h_best + slots);
  int* h_bids = h_node + slots;
  unsigned* s_touched = reinterpret_cast<unsigned*>(h_bids + slots);
  const int n_ent = g * kTopR;

  if (a.smem_lists) {
    for (long long i = tid; i < words; i += kThreads) {
      s_dyn[i] = __ldcg(reinterpret_cast<const unsigned long long*>(
          first.p + i));
    }
  }
  for (int i = tid; i < slots; i += kThreads) {
    h_best[i] = 0;
    h_node[i] = -1;
    h_bids[i] = 0;
  }
  for (int i = tid; i < (n + 31) / 32; i += kThreads) s_touched[i] = 0;
  if (tid < g) {
    s_rem[tid] = a.kk[tid];
#pragma unroll
    for (int d = 0; d < kDims; ++d) s_ask[tid][d] = a.ask[tid * kDims + d];
    fold_key((unsigned long long)a.seeds[tid], (uint32_t)t, s_key[tid][0],
             s_key[tid][1]);
  }
  if (tid < g) s_need[tid] = 0;
  if (tid < kLanes) s_tcnt[tid] = 0;
  if (tid == 0) {
    int live = 0;
    for (int i = 0; i < g; ++i) live += a.kk[i] > 0;
    s_scans = live;
    s_live = live > 0;
    s_progress = 1;
  }
  __syncthreads();

  B5_STAMP(6)
  int rnd = 0;
  for (;;) {
    if (!(rnd < a.rounds && s_progress && s_live)) break;
    B5_STAMP(rnd ? 8 : 0)  // k 0: the loop condition

    // 1. after a round, each row with demand drops the nodes the round
    //    touched from its lists and inserts their new keys
    if (rnd > 0) {
      for (int row = tid / kLanes; row < g; row += kRowsAtOnce) {
        const int l = tid & (kLanes - 1);
        // a lane's list holds its home nodes alone: none was touched
        // where its bucket is empty
        if (s_rem[row] <= 0 || s_toff[l] == s_toff[l + 1]) continue;
        int c = (int)L.count(row, l);
        uint64_t fl = L.floor(row, l);
        int w = 0;
        for (int j = 0; j < c; ++j) {
          const uint64_t key = *L.at(row, j, l);
          const int i = key_idx(key);
          const bool touched = (s_touched[i >> 5] >> (i & 31)) & 1u;
          if (!touched) *L.at(row, w++, l) = key;
        }
        c = w;
        const float a_g[kDims] = {s_ask[row][0], s_ask[row][1],
                                  s_ask[row][2], s_ask[row][3]};
        for (int p = s_toff[l]; p < s_toff[l + 1]; ++p) {
          const uint64_t key =
              pair_key<false>(a, used, price, row, s_tnode[p], a_g,
                              s_key[row][0], s_key[row][1], span);
          if (key != 0) list_insert(L, row, l, key, c, fl);
        }
        L.count(row, l) = (uint64_t)c;
        L.floor(row, l) = fl;
      }
      __syncthreads();
      for (int p = tid; p < s_toff[kLanes]; p += kThreads) {
        s_touched[s_tnode[p] >> 5] = 0;
      }
      if (tid < kLanes) s_tcnt[tid] = 0;
    }

    B5_STAMP((rnd ? 8 : 0) + 1)  // k 1: the update
    // 2. each row's top R from its lists, one warp a row; a row whose R-th
    //    key lies below a lane's floor is scanned again and read again
    for (int pass = 0;; ++pass) {
      for (int row = 0; row < g; ++row) {
        if (!s_need[row]) continue;
        const float a_g[kDims] = {s_ask[row][0], s_ask[row][1],
                                  s_ask[row][2], s_ask[row][3]};
        scan_row<false>(a, L, used, price, row, a_g, s_key[row][0],
                        s_key[row][1], span);
        if (tid == 0) ++s_scans;
      }
      __syncthreads();
      for (int row = warp; row < g; row += kWarps) {
        if (pass > 0 && !s_need[row]) continue;
        bool need = false;
        if (s_rem[row] > 0) {
          need = lists_topr(L, row, ent_key + row * kTopR);
        } else if (lane < kTopR) {
          ent_key[row * kTopR + lane] = 0;
        }
        __syncwarp();
        if (lane == 0) s_need[row] = need;
      }
      __syncthreads();
      int any = 0;
      for (int row = 0; row < g; ++row) any |= s_need[row];
      if (!any) break;
      if (pass > 0) __trap();  // a scan leaves no row short
    }

    B5_STAMP((rnd ? 8 : 0) + 2)  // k 2: the top R and rescans
    // 3. winners (best bid on the node, ties to the lowest eval) and bids
    //    per node, from a table of the surfaced nodes; each won node's
    //    capacity against usage before the round
    if (tid == 0) {
      s_live = 0;
      s_progress = 0;
    }
    if (tid < n_ent) {
      const uint64_t key = ent_key[tid];
      if (key != 0) {
        const int idx = key_idx(key);
        int slot = hash_slot(idx, slots);
        for (;;) {
          const int prev = atomicCAS(&h_node[slot], -1, idx);
          if (prev == -1 || prev == idx) break;
          slot = (slot + 1) & (slots - 1);
        }
        atomicMax(reinterpret_cast<unsigned long long*>(&h_best[slot]),
                  (unsigned long long)best_key(key_val(key), tid / kTopR));
        atomicAdd(&h_bids[slot], 1);
        ent_slot[tid] = slot;
      }
    }
    __syncthreads();
    if (tid < n_ent) {
      const uint64_t key = ent_key[tid];
      int bids = 0;
      float cap = 0.0f;
      if (key != 0) {
        const int idx = key_idx(key);
        const int ge = tid / kTopR;
        const int slot = ent_slot[tid];
        bids = h_bids[slot];
        if (h_best[slot] == best_key(key_val(key), ge)) {
          float per = INFINITY;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            const float a_d = s_ask[ge][d];
            if (a_d > 0.0f) {
              const float av = a.avail[idx * kDims + d];
              const float cap_d =
                  a.evict ? __fadd_rn(av, a.evict[idx * kDims + d]) : av;
              const float free_d = __fsub_rn(cap_d, used[idx * kDims + d]);
              per = fminf(per, floorf(__fdiv_rn(free_d, a_d)));
            }
          }
          cap = fmaxf(per, 0.0f);
        }
      }
      ent_bids[tid] = bids;
      ent_cap[tid] = cap;
    }
    __syncthreads();

    B5_STAMP((rnd ? 8 : 0) + 3)  // k 3: the winners
    // 4. each row spends its demand over its won nodes in score order:
    //    amt = clip(remaining - (cumsum(cap) - cap), 0, cap), NaN -> 0
    if (tid < g) {
      const float rem_f = (float)s_rem[tid];
      float cum = 0.0f;
      int total = 0;
      for (int j = 0; j < kTopR; ++j) {
        const int e = tid * kTopR + j;
        const float c = ent_cap[e];
        cum = __fadd_rn(cum, c);
        const float x = __fsub_rn(rem_f, __fsub_rn(cum, c));
        const int amt = (int)fminf(fmaxf(x, 0.0f), c);
        ent_amt[e] = amt;
        total += amt;
      }
      s_rem[tid] -= total;
      if (s_rem[tid] > 0) s_live = 1;
      if (total > 0) s_progress = 1;
    }
    __syncthreads();

    B5_STAMP((rnd ? 8 : 0) + 4)  // k 4: the fill
    // 5. the round's usage, take and price updates (one winner per node);
    //    the nodes it fills are the touched ones, counted by home lane;
    //    the table's slots are emptied for the next round
    if (tid < n_ent) {
      const uint64_t key = ent_key[tid];
      const int amt = ent_amt[tid];
      if (key != 0) {
        const int idx = key_idx(key);
        const int row = tid / kTopR;
        const int slot = ent_slot[tid];
        h_best[slot] = 0;
        h_node[slot] = -1;
        h_bids[slot] = 0;
        if (amt > 0) {
          const float af = (float)amt;
#pragma unroll
          for (int d = 0; d < kDims; ++d) {
            used[idx * kDims + d] = __fadd_rn(
                used[idx * kDims + d], __fmul_rn(s_ask[row][d], af));
          }
          take[(long long)row * n + idx] += amt;
          atomicOr(&s_touched[idx >> 5], 1u << (idx & 31));
          ent_slot[tid] = atomicAdd(&s_tcnt[home_lane(idx)], 1);
        }
        const float cap = ent_cap[tid];
        if (cap > 0.0f && (float)amt >= cap && ent_bids[tid] > 1) {
          price[idx] = __fadd_rn(price[idx], eps);
        }
      }
    }
    __syncthreads();
    if (warp == 0) {  // the lanes' offsets into s_tnode
      const int c0 = s_tcnt[2 * lane], c1 = s_tcnt[2 * lane + 1];
      int incl = c0 + c1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const int excl = incl - c0 - c1;
      s_toff[2 * lane] = excl;
      s_toff[2 * lane + 1] = excl + c0;
      if (lane == 31) s_toff[kLanes] = incl;
    }
    __syncthreads();
    if (tid < n_ent && ent_amt[tid] > 0) {
      const int idx = key_idx(ent_key[tid]);
      s_tnode[s_toff[home_lane(idx)] + ent_slot[tid]] = idx;
    }
    __syncthreads();  // the next round's update reads every bucket
    B5_STAMP((rnd ? 8 : 0) + 5)  // k 5: the updates and buckets
    ++rnd;
  }
  if (tid == 0) {
    a.rounds_out[t] = rnd;
    if (a.scans_out) a.scans_out[t] = s_scans;
    B5_SPLIT_END(t)
  }
}

// ---- the pick (B6) ----

constexpr int kPickThreads = 256;
constexpr int kPickWarps = kPickThreads / 32;
constexpr int kMinPickChunk = 256;
constexpr int kMaxPickChunk = 1024;  // a chunk's tree in shared memory
constexpr int kMaxPickPad = 65536;
// chunk sums an arm may have, and a combining lane's share of them
constexpr int kMaxPickChunks = kMaxPickPad / kMinPickChunk;
constexpr int kLaneSums = kMaxPickChunks / 32;
constexpr int kMaxPickArms = 64;  // the restarts and the greedy arm
constexpr int kPickItems = 384;   // the items a launch aims at
// CTAs each card holds at once (0 until its first launch)
int g_pick_held[nt_mesh::kMaxCards];

struct PickArgs {
  const float* avail;
  const float* used_t;
  const int* take_t;
  const int* rounds_t;
  const float* used_g;
  const int16_t* counts_g;
  float* used_out;
  int16_t* counts_out;
  float* info;
  float* sums;     // (T + 1, C) chunk tree sums
  int* placed;     // (T + 1, C) chunk placed counts
  unsigned* barrier;
  int n_t, g, n, chunk, chunks;
};

// Item (arm, c): the pairwise tree of placed x fitness over the nodes
// [c chunk, (c + 1) chunk) of the arm (arm == n_t: the greedy arm) and its
// placed count, into the scratch
__device__ void pick_chunk(const PickArgs& a, int arm, int c, float* tree,
                           int* warp_placed) {
  const int tid = threadIdx.x;
  const bool greedy = arm == a.n_t;
  const long long n = a.n;
  const float* used = greedy ? a.used_g : a.used_t + arm * n * kDims;
  const int* take = a.take_t + arm * (long long)a.g * n;
  const int base = c * a.chunk;
  int local = 0;
  for (int j = tid; j < a.chunk; j += kPickThreads) {
    const int i = base + j;
    float v = 0.0f;
    if (i < n) {
      int cnt = 0;
      if (greedy) {
        for (int row = 0; row < a.g; ++row) cnt += a.counts_g[row * n + i];
      } else {
#pragma unroll 4
        for (int row = 0; row < a.g; ++row) cnt += take[row * n + i];
      }
      v = __fmul_rn((float)cnt, fit_score(a.avail + i * kDims,
                                          used + i * kDims));
      local += cnt;
    }
    tree[j] = v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_xor_sync(0xffffffffu, local, off);
  }
  if ((tid & 31) == 0) warp_placed[tid >> 5] = local;
  __syncthreads();
  // v[i] = v[2i] + v[2i+1] until one is left (kernels._pairwise_sum_xp)
  const float total =
      block_pairwise_sum<kPickThreads, kMaxPickChunk / 2 / kPickThreads>(
          tree, a.chunk);
  if (tid == 0) {
    int placed = 0;
    for (int w = 0; w < kPickWarps; ++w) placed += warp_placed[w];
    a.sums[arm * a.chunks + c] = total;
    a.placed[arm * a.chunks + c] = placed;
  }
  __syncthreads();  // warp_placed is reused by the next item
}

// One warp: the pairwise tree over the c (a power of two, at most
// kMaxPickChunks) chunk sums v written by other CTAs; each lane first sums
// its run of c / 32 consecutive ones, then the lanes' sums pair up by
// shuffles. Every lane gets the total.
__device__ float chunk_tree(const float* v, int c, int lane) {
  const int q = c > 32 ? c / 32 : 1;
  float r[kLaneSums];
#pragma unroll
  for (int j = 0; j < kLaneSums; ++j) {
    const int idx = lane * q + j;
    r[j] = j < q && idx < c ? __ldcg(v + idx) : 0.0f;
  }
#pragma unroll
  for (int h = kLaneSums / 2; h >= 1; h >>= 1) {
    if (2 * h <= q) {
#pragma unroll
      for (int j = 0; j < h; ++j) r[j] = __fadd_rn(r[2 * j], r[2 * j + 1]);
    }
  }
  float s = r[0];
  for (int off = 1; off < c / q; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, s, off);
    if ((lane & (2 * off - 1)) == 0) s = __fadd_rn(s, y);
  }
  return __shfl_sync(0xffffffffu, s, 0);
}

__global__ void __launch_bounds__(kPickThreads)
batch_pick_kernel(PickArgs a) {
  __shared__ float tree[kMaxPickChunk];
  __shared__ int warp_placed[kPickWarps];
  __shared__ float s_score[kMaxPickArms];
  __shared__ int s_placed[kMaxPickArms];
  const int arms = a.n_t + 1;
  const int items = arms * a.chunks;
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    pick_chunk(a, w / a.chunks, w % a.chunks, tree, warp_placed);
  }
  group_sync(a.barrier, gridDim.x, false);
  const int lane = threadIdx.x & 31;
  for (int arm = threadIdx.x >> 5; arm < arms; arm += kPickWarps) {
    const float score = chunk_tree(a.sums + arm * a.chunks, a.chunks, lane);
    int placed = 0;
    for (int c = lane; c < a.chunks; c += 32) {
      placed += __ldcg(a.placed + arm * a.chunks + c);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      placed += __shfl_xor_sync(0xffffffffu, placed, off);
    }
    if (lane == 0) {
      s_score[arm] = score;
      s_placed[arm] = placed;
    }
  }
  __syncthreads();
  // the restart chain (earliest on exact ties), then auction vs greedy
  int best_t = 0;
  float best_score = s_score[0];
  int best_placed = s_placed[0];
  for (int t = 1; t < a.n_t; ++t) {
    if (s_placed[t] > best_placed ||
        (s_placed[t] == best_placed && s_score[t] > best_score)) {
      best_t = t;
      best_score = s_score[t];
      best_placed = s_placed[t];
    }
  }
  const float score_g = s_score[a.n_t];
  const int placed_g = s_placed[a.n_t];
  const bool pick_a = best_placed > placed_g ||
                      (best_placed == placed_g && best_score > score_g);
  const long long n = a.n;
  const long long gid = (long long)blockIdx.x * kPickThreads + threadIdx.x;
  const long long stride = (long long)gridDim.x * kPickThreads;
  const float* used_src = pick_a ? a.used_t + best_t * n * kDims : a.used_g;
  for (long long i = gid; i < n * kDims; i += stride) {
    a.used_out[i] = used_src[i];
  }
  const int* take = a.take_t + best_t * (long long)a.g * n;
  for (long long i = gid; i < (long long)a.g * n; i += stride) {
    a.counts_out[i] = pick_a ? (int16_t)take[i] : a.counts_g[i];
  }
  if (gid == 0) {
    a.info[0] = best_score;
    a.info[1] = score_g;
    a.info[2] = (float)best_placed;
    a.info[3] = (float)placed_g;
    a.info[4] = (float)a.rounds_t[best_t];
    a.info[5] = pick_a ? 1.0f : 0.0f;
  }
}

}  // namespace

// the list scratch a launch needs, in 4-byte words: every restart's lists
// (the first round's scans write them there)
extern "C" long long nt_auction_scratch_words(int n_restarts, int g) {
  return (long long)n_restarts * list_words(g) * 2;
}

// used0, avail (n, 4) f32 (16-byte aligned); feas (g, n) bool; aff
// (g, n) f32; ask (g, 4) f32; k (g,) int32; seeds (g,) int64; params (2,
// T) f32: the price temperatures, then the jitter widths; evict (n, 4) f32
// (16-byte aligned) and net_prio (n,) f32, or both null; outputs used (T,
// n, 4), take (T, g, n) int32, rounds (T,) int32, price (T, n) f32
// scratch; lists the scratch of nt_auction_scratch_words; scans (T,)
// int32 or null; barrier a group of zeroed words (mesh.cuh), reused by
// launches in stream order.
// One cooperative launch: T x C CTAs scan the first round, C a restart
// (as many as the card holds at once, at most G), then T of them run the
// rounds.
extern "C" int nt_auction(const void* used0, const void* avail,
                          const void* feas, const void* aff, const void* ask,
                          const void* k, const void* seeds,
                          const void* params, const void* evict,
                          const void* net_prio, void* used_out,
                          void* take_out, void* rounds_out, void* price_buf,
                          void* lists, void* scans_out, void* barrier,
                          int n_restarts, int g, int n, int rounds,
                          void* stream) {
  if (n_restarts <= 0) return 0;
  if (g < 1 || g > kMaxG || n < 1 || n > kMaxNodes || lists == nullptr ||
      barrier == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long list_bytes = list_words(g) * 8;
  const long long rest = (long long)hash_slots(g) * 16 + kTouchedBytes;
  const bool smem_lists = list_bytes + rest <= kDynSmem;
  const size_t smem = (size_t)((smem_lists ? list_bytes : 0) + rest);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, auction_kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int held = sms * per_sm;
  if (held < n_restarts) return (int)cudaErrorCooperativeLaunchTooLarge;
  AuctionArgs a;
  a.used0 = (const float*)used0;
  a.avail = (const float*)avail;
  a.feas = (const uint8_t*)feas;
  a.aff = (const float*)aff;
  a.ask = (const float*)ask;
  a.kk = (const int*)k;
  a.seeds = (const long long*)seeds;
  a.params = (const float*)params;
  a.evict = (const float*)evict;
  a.net_prio = (const float*)net_prio;
  a.used_out = (float*)used_out;
  a.take_out = (int*)take_out;
  a.rounds_out = (int*)rounds_out;
  a.price_buf = (float*)price_buf;
  a.lists = (uint64_t*)lists;
  a.scans_out = (int*)scans_out;
  a.barrier = (unsigned*)barrier;
  a.n_t = n_restarts;
  a.g = g;
  a.n = n;
  a.rounds = rounds;
  a.scan_ctas = held / n_restarts < g ? held / n_restarts : g;
  a.smem_lists = smem_lists;
  void* kargs[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)auction_kernel, dim3(n_restarts * a.scan_ctas),
      dim3(kThreads), kargs, smem, (cudaStream_t)stream);
}

// the pick's scratch in 4-byte words: a (sum, placed) pair an item at the
// smallest chunk
extern "C" long long nt_batch_pick_scratch_words(int n_restarts, int n) {
  int p = 1;
  while (p < n) p <<= 1;
  const long long chunks = p > kMinPickChunk ? p / kMinPickChunk : 1;
  return 2LL * (n_restarts + 1) * chunks;
}

// avail, used_g (n, 4) f32; used_t (T, n, 4) f32; take_t (T, g, n) int32;
// rounds_t (T,) int32; counts_g (g, n) int16; outputs used (n, 4) f32,
// counts (g, n) int16, info (6,) f32; scratch nt_batch_pick_scratch_words
// words, scratch_words their count (a smaller buffer is refused); barrier
// a group of zeroed words (mesh.cuh), reused by launches in stream order.
// One cooperative launch of at most (T + 1) x C CTAs, as many as the card
// holds at once.
extern "C" int nt_batch_pick(const void* avail, const void* used_t,
                             const void* take_t, const void* rounds_t,
                             const void* used_g, const void* counts_g,
                             void* used_out, void* counts_out, void* info,
                             void* scratch, void* barrier, int n_restarts,
                             int g, int n, int scratch_words, void* stream) {
  if (n_restarts < 1 || n_restarts + 1 > kMaxPickArms || g < 1 || n < 1 ||
      barrier == nullptr ||
      nt_batch_pick_scratch_words(n_restarts, n) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < n) p <<= 1;
  if (p > kMaxPickPad) return (int)cudaErrorInvalidValue;
  // the smallest chunk whose items stay within kPickItems
  int chunk = kMinPickChunk;
  while (chunk < kMaxPickChunk && (n_restarts + 1) * (p / chunk) > kPickItems)
    chunk <<= 1;
  if (chunk > p) chunk = p;
  PickArgs a;
  a.avail = (const float*)avail;
  a.used_t = (const float*)used_t;
  a.take_t = (const int*)take_t;
  a.rounds_t = (const int*)rounds_t;
  a.used_g = (const float*)used_g;
  a.counts_g = (const int16_t*)counts_g;
  a.used_out = (float*)used_out;
  a.counts_out = (int16_t*)counts_out;
  a.info = (float*)info;
  a.chunk = chunk;
  a.chunks = p / chunk;
  a.sums = (float*)scratch;
  a.placed = (int*)scratch + (n_restarts + 1) * a.chunks;
  a.barrier = (unsigned*)barrier;
  a.n_t = n_restarts;
  a.g = g;
  a.n = n;
  const int items = (n_restarts + 1) * a.chunks;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= nt_mesh::kMaxCards) return (int)cudaErrorInvalidDevice;
  if (g_pick_held[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, batch_pick_kernel, kPickThreads, 0);
    if (err != cudaSuccess) return (int)err;
    g_pick_held[dev] = sms * per_sm;
  }
  const int grid = items < g_pick_held[dev] ? items : g_pick_held[dev];
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&a};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)batch_pick_kernel, dim3(grid), dim3(kPickThreads), kargs,
      0, (cudaStream_t)stream);
}

#ifdef B5_SPLIT
extern "C" int b5_split_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, b5_split_cycles,
                                   sizeof(b5_split_cycles));
}
#endif
