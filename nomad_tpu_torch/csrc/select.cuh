// The cap-weighted prefix of an order, found without sorting it: the
// selection of B11 (bulk_scan.cu) and B1 (bulk_fill.cu).
//
// The fill: positions in (key asc, position asc) order, key a 32-bit
// order key (sort.cuh's desc_key of a score: ascending key is descending
// score, -0.0 with +0.0), each with a weight w (its cap clipped to the
// budget; w == 0 never takes), and
//   take = clip(budget - (weight of everything before it), 0, w).
// threshold_select finds the level T, the smallest key at which the weight
// of the keys <= T reaches the budget (or "all" when the total weight does
// not exceed it). Then every position with key < T takes its whole weight
// (together they weigh less than the budget), every position with key > T
// takes nothing, and the positions with key == T share what is left in
// position order: one block-wide scan (threshold_base, take_at). Cap-0
// positions weigh nothing wherever they fall, so the takes equal those of
// the full stable sort and scan.
//
// T is found by walking the distinct levels from the best, one block
// reduction a level (the lowest key above the last, with its weight and
// count) under one barrier, for at most kLevels levels (a greedy fill
// whose first node can take the budget ends at the first, and where one
// position holds the level no scan follows), then by bisecting the keys
// between the last level and the worst key, a block sum of the weight at
// or below the midpoint each (at most 32; a prefix of many cap-1
// positions ends here).
//
// The block: every thread owns `chunk` consecutive positions (thread t's
// come after thread t - 1's), their keys and caps in shared (or global)
// memory, and a Summary of them in registers; a reduction reads a thread's
// positions only where the level or the midpoint falls inside its key
// range. Where the positions lie is the caller's: the functions take any
// layout with Positions' members (key, cap, count(), slot(q), and kMaxQ,
// the most positions a thread holds).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sort.cuh"

namespace nt_select {

constexpr int kLevels = 4;

struct Threshold {
  uint32_t level;  // T
  uint32_t above;  // weight of the keys < T
  uint32_t total;  // weight of every key
  bool all;        // total <= budget: every position takes its weight
  bool single;     // one position holds the level (no scan needed)
};

// A thread's positions: position t x chunk + q (q < chunk, below n) in slot
// q x blockDim + t of key and cap, in shared memory, so a warp's reads are
// conflict-free.
struct Positions {
  static constexpr int kMaxQ = 16;  // positions a thread holds at most
  uint32_t* key;  // desc_key of the score
  uint16_t* cap;  // the cap, uncapped by the budget
  int chunk, n;
  __device__ int count() const {
    const int first = (int)threadIdx.x * chunk;
    return max(0, min(chunk, n - first));
  }
  __device__ int slot(int q) const { return q * (int)blockDim.x + threadIdx.x; }
};

// What a thread's live (cap > 0) positions hold: the lowest and highest
// key, the weight (caps clipped to the budget), and at the lowest key its
// weight, its count and the first position holding it. With it most
// threads answer a reduction without reading their positions.
struct Summary {
  uint32_t lo, hi, weight, lo_weight, lo_count;
  int lo_q;
};

// A position's weight: its cap clipped to the budget
__device__ __forceinline__ uint32_t weight(uint32_t cap, uint32_t budget) {
  return cap < budget ? cap : budget;
}

template <class Ps>
__device__ inline Summary summarize(const Ps& ps, uint32_t budget) {
  Summary sm{0xffffffffu, 0u, 0u, 0u, 0u, 0};
  const int m = ps.count();
#pragma unroll
  for (int q = 0; q < Ps::kMaxQ; ++q) {
    if (q < m) {
      const uint32_t cap = ps.cap[ps.slot(q)];
      const uint32_t key = ps.key[ps.slot(q)];
      if (cap) {
        const uint32_t w = weight(cap, budget);
        if (key < sm.lo) {
          sm.lo = key;
          sm.lo_weight = w;
          sm.lo_count = 1u;
          sm.lo_q = q;
        } else if (key == sm.lo) {
          sm.lo_weight += w;
          sm.lo_count += 1u;
        }
        sm.hi = max(sm.hi, key);
        sm.weight += w;
      }
    }
  }
  return sm;
}

// A level: the lowest key of a set, with the weight and count at it.
// Combining two keeps the lower key, or adds them where the keys are
// equal; (0xffffffff, 0, 0) is the empty set.
struct Level {
  uint32_t key, weight, count;
};

__device__ __forceinline__ Level combine(const Level& a, const Level& b) {
  if (b.key < a.key) return b;
  if (a.key < b.key) return a;
  return {a.key, a.weight + b.weight, a.count + b.count};
}

// A warp's lowest level: the min key, then the sums of the weights and
// counts held at it
__device__ __forceinline__ Level warp_level(const Level& x) {
  const uint32_t key = __reduce_min_sync(0xffffffffu, x.key);
  const bool at = x.key == key;
  return {key, __reduce_add_sync(0xffffffffu, at ? x.weight : 0u),
          __reduce_add_sync(0xffffffffu, at ? x.count : 0u)};
}

// The block's lowest level, and the max of hi and the sum of tot, to
// every thread; one __syncthreads. red holds 2 x 5 words a warp, used by
// turns (parity flips each call), so a call's writes never meet the reads
// of the call before.
__device__ __forceinline__ Level block_level(Level x, uint32_t& hi,
                                             uint32_t& tot, uint32_t* red,
                                             int& parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_level(x);
  hi = __reduce_max_sync(0xffffffffu, hi);
  tot = __reduce_add_sync(0xffffffffu, tot);
  uint32_t* r = red + parity * 5 * nw;
  if (lane == 0) {
    r[warp] = x.key;
    r[nw + warp] = x.weight;
    r[2 * nw + warp] = x.count;
    r[3 * nw + warp] = hi;
    r[4 * nw + warp] = tot;
  }
  __syncthreads();
  const bool in = lane < nw;
  x = warp_level({in ? r[lane] : 0xffffffffu, in ? r[nw + lane] : 0u,
                  in ? r[2 * nw + lane] : 0u});
  hi = __reduce_max_sync(0xffffffffu, in ? r[3 * nw + lane] : 0u);
  tot = __reduce_add_sync(0xffffffffu, in ? r[4 * nw + lane] : 0u);
  parity ^= 1;
  return x;
}

// The block's sum of v, to every thread; one __syncthreads (red as
// block_level's)
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red,
                                              int& parity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = __reduce_add_sync(0xffffffffu, v);
  uint32_t* r = red + parity * 5 * nw;
  if (lane == 0) r[warp] = v;
  __syncthreads();
  v = __reduce_add_sync(0xffffffffu, lane < nw ? r[lane] : 0u);
  parity ^= 1;
  return v;
}

// This thread's lowest level above `level`
template <class Ps>
__device__ inline Level level_above(const Ps& ps, const Summary& sm,
                                    uint32_t level, uint32_t budget) {
  if (!sm.weight || sm.hi <= level) return {0xffffffffu, 0u, 0u};
  if (sm.lo > level) return {sm.lo, sm.lo_weight, sm.lo_count};
  Level x{0xffffffffu, 0u, 0u};
  const int m = ps.count();
#pragma unroll
  for (int q = 0; q < Ps::kMaxQ; ++q) {
    if (q < m) {
      const uint32_t cap = ps.cap[ps.slot(q)];
      const uint32_t key = ps.key[ps.slot(q)];
      if (cap && key > level) x = combine(x, {key, weight(cap, budget), 1u});
    }
  }
  return x;
}

// The level T of the fill of `budget` (> 0) over the block's positions,
// sm each thread's Summary at this budget. The sum of all weights must fit
// in 32 bits.
template <class Ps>
__device__ inline Threshold threshold_select(const Ps& ps,
                                             const Summary& sm,
                                             uint32_t budget, uint32_t* red,
                                             int& parity) {
  uint32_t mx = sm.hi, tot = sm.weight;
  Level at = block_level({sm.lo, sm.lo_weight, sm.lo_count}, mx, tot, red,
                         parity);
  Threshold th{0u, 0u, tot, tot <= budget, false};
  if (th.all) return th;
  uint32_t above = 0u;
  for (int it = 1;; ++it) {
    if (above + at.weight >= budget) {
      th.level = at.key;
      th.above = above;
      th.single = at.count == 1u;
      return th;
    }
    above += at.weight;  // the total exceeds the budget: a next level
    if (it == kLevels) break;
    uint32_t unused0 = 0u, unused1 = 0u;
    at = block_level(level_above(ps, sm, at.key, budget), unused0, unused1,
                     red, parity);
  }
  // the smallest x in (the last level, mx] whose weight at or below
  // reaches the budget; the weight below `lo` is `above` throughout
  uint32_t lo = at.key + 1u, hi = mx;
  const int m = ps.count();
  while (lo < hi) {
    const uint32_t mid = lo + (hi - lo) / 2;
    uint32_t below = 0u;
    if (sm.weight && sm.hi <= mid) {
      below = sm.weight;
    } else if (sm.weight && sm.lo <= mid) {
#pragma unroll
      for (int q = 0; q < Ps::kMaxQ; ++q) {
        if (q < m && ps.key[ps.slot(q)] <= mid) {
          below += weight(ps.cap[ps.slot(q)], budget);
        }
      }
    }
    below = block_sum(below, red, parity);
    if (below >= budget) {
      hi = mid;
    } else {
      lo = mid + 1;
      above = below;
    }
  }
  th.level = lo;
  th.above = above;
  return th;
}

// threshold_select's level found by digits (B1's form), for orders whose
// fill reaches deep: where the best level does not cover the budget, T lies
// in (that level, the worst key], whose keys share their bits above the
// highest bit where those two differ. A most-significant-digit-first radix
// search then fixes T 8 bits a pass: a histogram of the weights of the
// positions whose key holds the prefix found so far, by their next 8 bits
// (shared-memory atomics; integer sums, exact in any order), and one warp's
// scan of it for the first digit at which the weight reaches the budget.
// Three or four passes of two __syncthreads each, where the bisection takes
// one block sum a bit. hist: kRadixWords words, the first 512 (a weight
// and a count a digit) zero on entry and on return (the scanning warp
// clears what it read); the last pass also counts the positions at each
// digit, for `single`.
constexpr int kRadixWords = 2 * 256 + 4;

template <class Ps>
__device__ inline Threshold threshold_radix(const Ps& ps, const Summary& sm,
                                            uint32_t budget, uint32_t* hist,
                                            uint32_t* red, int& parity) {
  uint32_t mx = sm.hi, tot = sm.weight;
  const Level at = block_level({sm.lo, sm.lo_weight, sm.lo_count}, mx, tot,
                               red, parity);
  Threshold th{0u, 0u, tot, tot <= budget, false};
  if (th.all) return th;
  if (at.weight >= budget) {
    th.level = at.key;
    th.single = at.count == 1u;
    return th;
  }
  uint32_t* cnt = hist + 256;
  uint32_t* out = hist + 512;  // the digit, the weight below it, single
  int shift = 32 - __clz(at.key ^ mx);  // the bits below the common prefix
  uint32_t prefix = (uint32_t)((uint64_t)mx >> shift);
  uint32_t above = 0u;  // the weight of the keys below the prefix's range
  const int m = ps.count();
  while (shift > 0) {
    const int bits = shift < 8 ? shift : 8;
    shift -= bits;
    const bool last = shift == 0;
    const uint32_t lo = (uint32_t)((uint64_t)prefix << (shift + bits));
    const uint32_t hi = lo | (uint32_t)(((uint64_t)1 << (shift + bits)) - 1);
    if (sm.weight && sm.lo <= hi && sm.hi >= lo) {
#pragma unroll
      for (int q = 0; q < Ps::kMaxQ; ++q) {
        if (q < m) {
          const uint32_t cap = ps.cap[ps.slot(q)];
          const uint32_t key = ps.key[ps.slot(q)];
          if (cap && key >= lo && key <= hi) {
            const uint32_t dgt = (key >> shift) & ((1u << bits) - 1u);
            atomicAdd(&hist[dgt], weight(cap, budget));
            if (last) atomicAdd(&cnt[dgt], 1u);
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // lane l scans digits 8l .. 8l + 7
      const int lane = threadIdx.x;
      uint32_t w8[8];
      uint32_t sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w8[j] = hist[8 * lane + j];
        hist[8 * lane + j] = 0u;
        sum += w8[j];
      }
      uint32_t incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      const uint32_t before = above + incl - sum;  // below lane's digits
      const bool reach = before + sum >= budget;
      const unsigned first = __ballot_sync(0xffffffffu, reach);
      if (lane == __ffs(first) - 1) {
        uint32_t b = before;
        int j = 0;
        while (b + w8[j] < budget) b += w8[j++];
        out[0] = (uint32_t)(8 * lane + j);
        out[1] = b;
        if (last) out[2] = cnt[8 * lane + j] == 1u ? 1u : 0u;
      }
      if (last) {
#pragma unroll
        for (int j = 0; j < 8; ++j) cnt[8 * lane + j] = 0u;
      }
    }
    __syncthreads();
    // (the next pass writes `out` after its own first barrier)
    prefix = (prefix << bits) | out[0];
    above = out[1];
    if (last) th.single = out[2] != 0u;
  }
  th.level = prefix;
  th.above = above;
  return th;
}

// The weight before this thread's first position at the level: the
// level's weight in earlier threads, after `above` (one block scan unless
// a single position holds the level; warp_tot is block_exclusive_scan's
// words, one a warp). Every thread calls it.
template <class Ps>
__device__ inline long long threshold_base(const Ps& ps,
                                           const Summary& sm,
                                           const Threshold& th,
                                           uint32_t budget, int* warp_tot) {
  if (th.all || th.single) return th.above;
  int local = 0;
  if (sm.weight && sm.lo <= th.level && th.level <= sm.hi) {
    const int m = ps.count();
#pragma unroll
    for (int q = 0; q < Ps::kMaxQ; ++q) {
      if (q < m && ps.key[ps.slot(q)] == th.level) {
        local += (int)weight(ps.cap[ps.slot(q)], budget);
      }
    }
  }
  return (long long)th.above + nt_sort::block_exclusive_scan(local, warp_tot);
}

// Whether this thread's positions can take anything under th
__device__ __forceinline__ bool may_take(const Summary& sm,
                                         const Threshold& th) {
  return sm.weight && (th.all || sm.lo <= th.level);
}

// The one position of this thread that takes, when a single position
// holds the level and this thread has nothing below it: its q, else -1.
__device__ __forceinline__ int single_taker(const Summary& sm,
                                           const Threshold& th) {
  return !th.all && th.single && sm.weight && sm.lo == th.level ? sm.lo_q
                                                                 : -1;
}

// One position's take, the thread's positions in order; excl starts at
// threshold_base and moves past each position at the level.
__device__ __forceinline__ uint32_t take_at(uint32_t key, uint32_t cap,
                                            const Threshold& th,
                                            uint32_t budget,
                                            long long& excl) {
  const uint32_t w = weight(cap, budget);
  if (th.all || key < th.level) return w;
  if (key > th.level) return 0u;
  const long long left = (long long)budget - excl;
  excl += w;
  return left <= 0 ? 0u : (uint32_t)min(left, (long long)w);
}

}  // namespace nt_select
