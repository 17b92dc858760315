// B11: the count-based bulk scan (solve_bulk and solve_bulk_fused), and
// B11': the tie-break permutation the fused form draws on the device.
//
// Replaces: _bulk_scan / solve_bulk (nomad_tpu/tensor/kernels.py:494-594),
// solve_bulk_fused (kernels.py:597-629), and its
// jax.random.permutation(jax.random.PRNGKey(seed), n) (kernels.py:618-619).
// The plain torch versions are solve_bulk_ref / solve_bulk_fused_ref in
// tensor/kernels.py and permutation_ref in tensor/prng.py.
//
// nt_bulk_scan computes, in tie-permuted node space (node j of the scan is
// canonical node tie_perm[j]), up to n_steps steps of at most `batch`
// placements of one task group, with remaining = k_total:
//   score   = B8 at every node (score.cuh; no node penalty, lowest explicit
//             boost -1, no distinct_property tables)
//   budget  = min(remaining, batch)
//   cap     = max(0, min_{ask_d > 0} floor((avail - used) / ask_d)), +inf
//             for an all-zero ask; 0 where score == NEG; at most 1 under
//             distinct_hosts or WorstFit; at most budget
//   order   = positions by score descending, position ascending (the
//             reference's stable argsort(-score), -0.0 equal to +0.0)
//   take    = clip(budget - exclusive_cumsum(cap in order), 0, cap)
//   used   += ask * take; placed_tg, placed_job += take; each spread's
//             value count += take where the node has the value;
//             remaining -= sum(take)
// and returns the per-node totals mapped back to canonical order
// (out[tie_perm[j]] = taken[j]), int32: k may exceed the int16 counts of
// the solver service (MAX_K = 32,767), which is why this route exists.
//
// Early exit, exact: a step that takes nothing leaves the carry unchanged,
// so every later step takes nothing too; the scan stops there or when
// remaining reaches 0. The reference runs all n_steps = k_pad / batch.
//
// nt_tie_perm computes jax.random.permutation(PRNGKey(seed), n) for a
// 32-bit seed and 1 <= n <= 65,536: the key is (0, seed); each of the
// `rounds` rounds (1 for n <= 1,625, 2 up to ~2.6M, computed by the caller
// as _shuffle does) is key, subkey = split(key), one 32-bit threefry draw
// per position from the subkey, and a stable sort of the current sequence
// by those draws (equal draws keep their order).
//
// Bound on the H100: neither bytes nor operations. B11 reads ~40 bytes a
// node and writes 4 (under 1 MB at N_pad 16,384, a fraction of a
// microsecond of HBM time); the work it needs is one score per node plus,
// per active step, a rescore and an ordering update of the few nodes that
// took placements. The time goes to the steps running one after another
// on one SM, each a few block-wide reductions behind barriers. B11' is
// ~2 x 20 threefry rounds a position and a sort of n keys; its time is
// the one-CTA sort's passes, each bound by one SM's integer issue rate.
//
// Design (B11): one CTA of 1024 threads runs the whole scan, so the carry
// chain needs only __syncthreads. The CTA gathers every per-node column into
// permuted order in a global scratch buffer (score.cuh's ScratchNodes
// layout, column-major, L2-resident), which also holds the usage and
// placement-count carry and the taken counts; the spread value tables live
// in shared memory and take their updates by integer atomics. Thread t owns
// the positions t x chunk .. t x chunk + chunk - 1 (chunk = N / 1024 rounded
// up) and keeps each one's order key, desc_key(score) (sort.cuh), and its
// cap uncapped by the budget (16 bits, two to a word) from step to step:
// in shared memory up to 16,384 positions (chunk <= 16), in the global
// scratch above (chunk 32 or 64, one kernel instance each, up to 65,536).
// A step clips the caps to the budget, finds the fill's level with
// select.cuh (threshold_select up to 16,384: a few block-wide reductions,
// no sort; threshold_radix above, B1's radix search, whose passes read a
// thread's positions once each where the bisection would read them once a
// bit), takes the fill there (threshold_base and take_at: one block scan),
// and the owner of each position that took updates its node's carry and
// rescores it (score.cuh's node_terms). With no spread (S == 0, the fused
// form) nothing else's score moves. With spreads every score moves through
// the value counts: the owner keeps the node's cached terms (in shared
// memory, or in the scratch where they do not fit, kShared false; always
// in the scratch above 16,384) and each step rebuilds the value tables and
// recomputes every key with cached_score.
//
// Design (B11'): two launches. Every round's words are drawn first, one
// thread a word on many SMs (they depend on the key chain alone, not on
// the sort). Then one CTA of 1,024 threads: a round loads its words into
// the first of two buffers of (u32 draw, u16 value) pairs, the value
// being the sequence so far (position i's value x[i]), then
// sorts the pairs by the draws' high halves with two LSD passes of 8-bit
// digits, each stable: warp w owns the positions [w x 2^span, (w + 1) x
// 2^span) and walks them in order, two groups of 32 at a time; lanes with
// one digit find each other with eight ballots (one a digit bit), so an
// item's rank is its digit's count so far in its warp plus its peers on
// lower lanes. A pass takes one block scan of its (digit, warp) counts in
// digit-major order, then walks once and scatters each item to its
// (digit, warp) offset plus its rank, counting it there by the next
// pass's digit and the warp that will walk it (the first pass's counts
// are taken as the draws are loaded). Then each run of equal high
// halves is sorted by insertion on the whole draw, which keeps equal
// draws in order: the whole is the stable sort by the draws. The pairs
// take 12 bytes a position in shared memory beside the 32 KB of counts up
// to 16,384 positions, and the CTA sorts the runs too. Above, the pairs
// take 16 bytes a position (one 8-byte store a pair) in a global scratch
// (L2-resident), the CTA is launched once a round, and the runs, which
// then hold most pairs, are sorted by a launch on many SMs, one thread a
// position, between rounds.
// Neither kernel calls a library sort or scan.
//
// More than 8 resource columns or 8 spreads (score.cuh's dims_wide) take
// a second instance of the scan (kWideDims, compiled in wide/bulk_scan.cu,
// chosen by the entry point from the shape): score.cuh's wide helpers, the
// cap's and the commit's loops over the columns with the ask in global
// memory (the commit writes a column and the rescore reads it back), and
// the value tables' spread rows spread over the warps. Its only refusal
// is the count tables' shared memory.
//
// Arithmetic: B8 is score.cuh's, bit for bit the plain version's; the cap
// uses __fsub_rn, __fdiv_rn and floorf; the carry update is
// __fadd_rn(used, __fmul_rn(ask, take)), the reference's multiply-add order
// (built with --fmad=false, no fast math). The counts equal the plain
// version's exactly.

#include "bulk_scan.cuh"

namespace {

// B11' sorts by 8-bit digits; the counts of one (digit, warp) are 16-bit
// (at most 2,048 a warp; the scanned offsets below 65,536), two arrays of
// them: a pass's own and the next pass's, counted while it scatters
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
constexpr int kScanWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kCountBytes = sizeof(uint16_t) * kBins * kScanWarps;

// The (draw, value) pairs of one buffer: two arrays in shared memory (6
// bytes a pair), or 8-byte pairs in the global scratch (one store a pair)
struct SplitPairs {
  uint32_t* k;
  uint16_t* v;
  // buffer `which` of two, in the shared memory past the counts
  __device__ static SplitPairs at(uint16_t* smem, uint2*, int n, int which) {
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
    uint16_t* vals = reinterpret_cast<uint16_t*>(keys + 2 * n);
    return {keys + which * n, vals + which * n};
  }
  __device__ uint32_t key(int i) const { return k[i]; }
  __device__ void load(int i, uint32_t& key, uint32_t& val) const {
    key = k[i];
    val = v[i];
  }
  __device__ void store(int i, uint32_t key, uint32_t val) const {
    k[i] = key;
    v[i] = (uint16_t)val;
  }
  __device__ void set_key(int i, uint32_t key) const { k[i] = key; }
  __device__ void set_val(int i, uint32_t val) const { v[i] = (uint16_t)val; }
  __device__ uint32_t val(int i) const { return v[i]; }
};

struct PackedPairs {
  uint2* p;
  __device__ static PackedPairs at(uint16_t*, uint2* gbuf, int n,
                                   int which) {
    return {gbuf + which * n};
  }
  __device__ uint32_t key(int i) const { return p[i].x; }
  __device__ void load(int i, uint32_t& key, uint32_t& val) const {
    const uint2 w = p[i];
    key = w.x;
    val = w.y;
  }
  __device__ void store(int i, uint32_t key, uint32_t val) const {
    p[i] = make_uint2(key, val);
  }
  __device__ void set_key(int i, uint32_t key) const { p[i].x = key; }
  __device__ void set_val(int i, uint32_t val) const { p[i].y = val; }
  __device__ uint32_t val(int i) const { return p[i].y; }
};

// bytes of the two buffers of n pairs: in shared memory, or packed in
// the global scratch
inline size_t perm_buffer_bytes(int n, bool in_smem) {
  return (size_t)n * 2 * (in_smem ? sizeof(uint32_t) + sizeof(uint16_t)
                                  : sizeof(uint2));
}
inline bool perm_in_smem(int n) {
  return 2 * kCountBytes + perm_buffer_bytes(n, true) <= kMaxSmem;
}

// one more item of `digit` in warp w's positions (two 16-bit counts a
// word, so a shared-memory atomic can take them)
__device__ __forceinline__ void count_item(uint16_t* cnt, int w, int digit) {
  const int slot = w * kBins + digit;
  atomicAdd(reinterpret_cast<unsigned*>(cnt) + (slot >> 1),
            1u << ((slot & 1) * 16));
}

// the lanes of the warp whose digit equals this lane's, among the valid
// ones (eight ballots; a ninth for the validity of a part-full group)
__device__ __forceinline__ unsigned same_digit(int digit, bool valid,
                                               bool full) {
  unsigned peers = full ? kFull : __ballot_sync(kFull, valid);
#pragma unroll
  for (int bit = 0; bit < kRadixBits; ++bit) {
    const bool on = (digit >> bit) & 1;
    const unsigned b = __ballot_sync(kFull, on);
    peers &= on ? b : ~b;
  }
  return peers;
}

// A group of 32 items takes its slots in warp w's counters `wcnt`: the
// lowest lane of each digit reads the digit's next slot and moves it on
// by the group's count; an item's slot is that plus its peers on lower
// lanes.
__device__ __forceinline__ int take_slot(uint16_t* wcnt, int digit,
                                         unsigned peers, bool valid) {
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int at = valid && lane == leader ? wcnt[digit] : 0;
  at = __shfl_sync(kFull, at, leader < 0 ? 0 : leader);
  if (valid && lane == leader) wcnt[digit] = (uint16_t)(at + __popc(peers));
  return at + __popc(peers & ((1u << lane) - 1u));
}

// One stable LSD pass: src's pairs scattered into dst by the digit of the
// draw at `shift`. `cnt` holds the pass's (digit, warp) counts; one block
// scan in digit-major order turns them into each (digit, warp)'s first
// slot. Then warp w walks its positions [w x 2^span, (w + 1) x 2^span) in
// order, two groups of 32 at a time, the second taking its slots after
// the first (a power of two, so that a position's warp is a shift). With `next` each item is counted by the next pass's digit
// and the warp whose positions it lands in. Ends on a block barrier.
template <class Pairs>
__device__ void radix_pass(const Pairs& src, const Pairs& dst, int n,
                           int span, int shift, uint16_t* cnt,
                           uint16_t* next, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (next) {
    for (int j = threadIdx.x; j < kBins * kScanWarps / 2; j += kThreads) {
      reinterpret_cast<unsigned*>(next)[j] = 0u;
    }
  }
  {
    // exclusive prefix of the counts in (digit, warp) order: thread t
    // takes digit t / 4, warps 8 (t % 4) .. 8 (t % 4) + 7
    constexpr int kPer = kBins * kScanWarps / kThreads;
    const int digit = threadIdx.x / (kScanWarps / kPer);
    const int w0 = threadIdx.x % (kScanWarps / kPer) * kPer;
    int c[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      c[q] = cnt[(w0 + q) * kBins + digit];
      sum += c[q];
    }
    int run = nt_sort::block_exclusive_scan(sum, warp_tot);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      cnt[(w0 + q) * kBins + digit] = (uint16_t)run;
      run += c[q];
    }
  }
  __syncthreads();
  uint16_t* wcnt = cnt + warp * kBins;
  const int lo = warp << span;
  const int hi = min(lo + (1 << span), n);
  uint32_t ka = 0u, xa = 0u, kb = 0u, xb = 0u;
  if (lo + lane < hi) src.load(lo + lane, ka, xa);
  if (lo + 32 + lane < hi) src.load(lo + 32 + lane, kb, xb);
  for (int base = lo; base < hi; base += 64) {
    const uint32_t k0 = ka, x0 = xa, k1 = kb, x1 = xb;
    const bool v0 = base + lane < hi;
    const bool v1 = base + 32 + lane < hi;
    if (base + 64 + lane < hi) src.load(base + 64 + lane, ka, xa);  // ahead
    if (base + 96 + lane < hi) src.load(base + 96 + lane, kb, xb);
    const int d0 = (int)((k0 >> shift) & (kBins - 1));
    const int d1 = (int)((k1 >> shift) & (kBins - 1));
    const unsigned p0 = same_digit(d0, v0, base + 32 <= hi);
    const unsigned p1 = same_digit(d1, v1, base + 64 <= hi);
    const int pos0 = take_slot(wcnt, d0, p0, v0);
    __syncwarp();
    const int pos1 = take_slot(wcnt, d1, p1, v1);
    if (v0) {
      dst.store(pos0, k0, x0);
      if (next) {
        count_item(next, pos0 >> span,
                   (int)((k0 >> (shift + kRadixBits)) & (kBins - 1)));
      }
    }
    if (v1) {
      dst.store(pos1, k1, x1);
      if (next) {
        count_item(next, pos1 >> span,
                   (int)((k1 >> (shift + kRadixBits)) & (kBins - 1)));
      }
    }
    __syncwarp();
  }
  __syncthreads();
}

// After the passes over the draws' high halves, the runs of equal high
// halves: two or more pairs at ~2.6% of the high halves' values at 16,384
// positions, ~26% at 65,536 (each value's count is Poisson with mean
// n / 2^16), and rarely more than a few. Whether one starts at i:
template <class Pairs>
__device__ __forceinline__ bool run_starts(const Pairs& p, int n, int i) {
  const uint32_t top = p.key(i) >> 16;
  return i + 1 < n && p.key(i + 1) >> 16 == top &&
         (i == 0 || p.key(i - 1) >> 16 != top);
}

// The run that starts at i, sorted by insertion on the whole draw, which
// is stable. Another thread reading the run's high halves meanwhile reads
// the same ones: the sort moves none.
template <class Pairs>
__device__ void sort_run(const Pairs& p, int n, int i) {
  const uint32_t top = p.key(i) >> 16;
  int end = i + 2;
  while (end < n && p.key(end) >> 16 == top) ++end;
  for (int j = i + 1; j < end; ++j) {
    uint32_t kj, xj;
    p.load(j, kj, xj);
    int t = j;
    for (; t > i && p.key(t - 1) > kj; --t) {
      uint32_t kt, xt;
      p.load(t - 1, kt, xt);
      p.store(t, kt, xt);
    }
    p.store(t, kj, xj);
  }
}

// Every run of the one CTA's pairs (n <= 16,384: at most 16 positions a
// thread): each thread marks the starts among its positions first, then
// sorts its runs, so a warp waits on its busiest lane's runs rather than
// on one run a position. Ends on a block barrier.
template <class Pairs>
__device__ void sort_runs(const Pairs& p, int n) {
  unsigned starts = 0u;
  for (int q = 0; threadIdx.x + q * kThreads < n; ++q) {
    if (run_starts(p, n, threadIdx.x + q * kThreads)) starts |= 1u << q;
  }
  for (; starts; starts &= starts - 1) {
    sort_run(p, n, threadIdx.x + (__ffs(starts) - 1) * kThreads);
  }
  __syncthreads();
}

// The runs of pairs in the global scratch, one thread a position, on many
// SMs.
__global__ void perm_runs_kernel(uint2* pairs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const PackedPairs p{pairs};
  if (i < n && run_starts(p, n, i)) sort_run(p, n, i);
}

__global__ void perm_out_kernel(const uint2* __restrict__ pairs, int n,
                                int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int)pairs[i].y;
}

// The draws of every round, one thread a (round, position): round r's
// subkey is r + 1 splits down the key chain, and its words do not depend
// on the sort, so all rounds are drawn at once, on many SMs.
__global__ void perm_draw_kernel(uint32_t seed, int n, int rounds,
                                 uint32_t* __restrict__ draws) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rounds * n) return;
  const int r = (int)(t / n);
  uint32_t k0 = 0u, k1 = seed;  // PRNGKey(seed) of a 32-bit seed
  uint32_t s0 = 0u, s1 = 0u;
  for (int q = 0; q <= r; ++q) {
    // key, subkey = split(key): the counters (0, 0) and (0, 1)
    uint32_t n0 = 0u, n1 = 0u;
    s0 = 0u;
    s1 = 1u;
    threefry2x32(k0, k1, n0, n1);
    threefry2x32(k0, k1, s0, s1);
    k0 = n0;
    k1 = n1;
  }
  draws[t] = threefry_bits(s0, s1, 0u, (uint32_t)(t - (long long)r * n));
}

// Rounds [r0, r1) of the sort: the pairs' values start as the positions
// at round 0; with `out` the values are written there at the end. Where
// the pairs are in the global scratch a launch takes one round, and the
// runs are sorted by perm_runs_kernel on many SMs after it (`runs` false).
template <class Pairs>
__global__ void __launch_bounds__(kThreads)
tie_perm_kernel(int n, int r0, int r1, bool runs,
                const uint32_t* __restrict__ draws, uint2* gbuf,
                int* __restrict__ out) {
  extern __shared__ uint16_t perm_smem[];
  __shared__ int warp_tot[kScanWarps];
  uint16_t* cnt = perm_smem;
  uint16_t* next = cnt + kBins * kScanWarps;
  const Pairs a = Pairs::at(next + kBins * kScanWarps, gbuf, n, 0);
  const Pairs b = Pairs::at(next + kBins * kScanWarps, gbuf, n, 1);
  // a warp walks 2^span positions: the least power of two, at least 64,
  // with which 32 warps cover n
  int span = 6;
  while ((kScanWarps << span) < n) ++span;

  if (r0 == 0) {
    for (int i = threadIdx.x; i < n; i += kThreads) a.set_val(i, i);
  }
  for (int r = r0; r < r1; ++r) {
    for (int j = threadIdx.x; j < kBins * kScanWarps / 2; j += kThreads) {
      reinterpret_cast<unsigned*>(cnt)[j] = 0u;
    }
    __syncthreads();
    // the round's draws, counted by the first pass's digit as they come
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t w = draws[(long long)r * n + i];
      a.set_key(i, w);
      count_item(cnt, i >> span, (int)((w >> 16) & (kBins - 1)));
    }
    __syncthreads();
    radix_pass(a, b, n, span, 16, cnt, next, warp_tot);
    radix_pass(b, a, n, span, 24, next, nullptr, warp_tot);
    if (runs) sort_runs(a, n);
  }
  if (out) {
    for (int i = threadIdx.x; i < n; i += kThreads) out[i] = (int)a.val(i);
  }
}

// (the narrow value tables give spread k to warp k: a block of fewer
// warps than spreads, at n below 32 x S, takes the wide instance too)
ScanKernel scan_kernel_for(const Dims& dm, bool cache_in_smem) {
  const bool wide = dims_wide(dm) || dm.s > scan_threads(dm.n) / 32;
  return wide ? nt_bulk::wide_kernel(dm.n, cache_in_smem)
              : scan_kernel_of<false>(dm.n, cache_in_smem);
}

}  // namespace

// f32 words of nt_bulk_scan's scratch: n * (2d + 7 + 2s), then, with
// spreads, the cached terms' room, then above kSharedNodes the keys and
// caps of every slot
extern "C" long long nt_bulk_scan_scratch_words(int n, int d, int s, int v) {
  const Dims dm{n, d, s, v, 0, 1};
  return (long long)n * (2 * d + 7 + 2 * s) +
         (long long)(scan_cache_room(dm, n) / 4) +
         (scan_wide(n) ? (long long)(scan_pos_bytes(n) / 4) : 0);
}

// avail (n, d) f32; dyn (n, d + 2) f32: used | placed_tg | placed_job;
// feas (n,) bool; aff (n,) f32; dev (n,) f32 or null (zeros); tie_perm (n,)
// int32; spread_node (2s, n), spread_tab (2s, v), spread_meta (s, 2) f32
// in pack_solve_args' layout (unread when s == 0); scalars (5 + d) f32:
// lowest_boost | tg_count | dh_job | dh_tg | spread_alg | ask[d]; scratch
// nt_bulk_scan_scratch_words(n, d, s, v) f32 words, scratch_words their
// count (a smaller buffer is refused); out (n,) int32.
extern "C" int nt_bulk_scan(const void* avail, const void* dyn,
                            const void* feas, const void* aff, const void* dev,
                            const void* tie_perm, const void* spread_node,
                            const void* spread_tab, const void* spread_meta,
                            const void* scalars, void* scratch, void* out,
                            int n, int d, int s, int v, int k_total, int batch,
                            int n_steps, int scratch_words, void* stream) {
  const Dims dm{n, d, s, v, 0, 1};
  if (n < 1 || n > kMaxNodes || d < 2 || s < 0 || v < 1 || batch < 1 ||
      batch > kMaxBatch || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  if (nt_bulk_scan_scratch_words(n, d, s, v) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  const bool wide = scan_wide(n);
  const size_t cache = s > 0 ? scan_cache_bytes(dm, n) : 0;
  const size_t work =
      table_bytes(dm) + (wide ? wide_work_bytes(n) : scan_work_bytes(n));
  const bool in_smem = !wide && work + cache <= kMaxSmem;
  const size_t smem = work + (in_smem ? cache : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const ScanKernel kernel = scan_kernel_for(dm, in_smem);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, scan_threads(n), smem, (cudaStream_t)stream>>>(
      (const float*)avail, (const float*)dyn, (const uint8_t*)feas,
      (const float*)aff, (const float*)dev, (const int*)tie_perm,
      (const float*)spread_node, (const float*)spread_tab,
      (const float*)spread_meta, (const float*)scalars, (float*)scratch,
      (int*)out, dm, k_total, batch, n_steps);
  return (int)cudaGetLastError();
}

// f32 words of nt_tie_perm's scratch: every round's draws (4 bytes a
// position a round), then, above 16,384 positions, the pairs (16 bytes a
// position; in shared memory below)
extern "C" long long nt_tie_perm_scratch_words(int n, int rounds) {
  return (long long)rounds * n +
         (perm_in_smem(n) ? 0 : (long long)(perm_buffer_bytes(n, false) / 4));
}

// out (n,) int32 = jax.random.permutation(PRNGKey(seed), n), 1 <= n <=
// 65,536; scratch nt_tie_perm_scratch_words(n, rounds) f32 words (null
// when 0), scratch_words their count (a smaller buffer is refused). The
// draws on many SMs, then the sort on one; above 16,384 positions a
// launch a round, each round's runs and the values out on many SMs.
extern "C" int nt_tie_perm(uint32_t seed, int n, int rounds, void* scratch,
                           void* out, int scratch_words, void* stream) {
  if (n < 1 || n > kMaxPermNodes || rounds < 0 ||
      nt_tie_perm_scratch_words(n, rounds) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  const bool in_smem = perm_in_smem(n);
  const size_t smem =
      2 * kCountBytes + (in_smem ? perm_buffer_bytes(n, true) : 0);
  auto kernel = in_smem ? tie_perm_kernel<SplitPairs>
                        : tie_perm_kernel<PackedPairs>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t* draws = (uint32_t*)scratch;
  const long long words = (long long)rounds * n;
  if (words > 0) {
    perm_draw_kernel<<<(unsigned)((words + 255) / 256), 256, 0, st>>>(
        seed, n, rounds, draws);
  }
  if (in_smem) {
    kernel<<<1, kThreads, smem, st>>>(n, 0, rounds, true, draws, nullptr,
                                      (int*)out);
    return (int)cudaGetLastError();
  }
  // a round a launch, its runs on many SMs, then the values out
  uint2* pairs = reinterpret_cast<uint2*>(draws + words);
  const unsigned blocks = (unsigned)((n + 255) / 256);
  for (int r = 0; r < rounds || r == 0; ++r) {
    kernel<<<1, kThreads, smem, st>>>(n, r, r < rounds ? r + 1 : r, false,
                                      draws, pairs, nullptr);
    if (r < rounds) perm_runs_kernel<<<blocks, 256, 0, st>>>(pairs, n);
  }
  perm_out_kernel<<<blocks, 256, 0, st>>>(pairs, n, (int*)out);
  return (int)cudaGetLastError();
}
