// B1 (with B2 inside): the chained greedy bulk fill of G evals over one
// usage carry, with its correction fold and its tie-break jitter.
//
// Replaces: _solve_bulk_multi_impl / solve_bulk_multi
// (nomad_tpu/tensor/kernels.py:666-763): the fold of the correction slots
// (:712), the jitter draw jax.random.uniform(PRNGKey(seed)) (:720-723) and
// the fill (:724-756), with the fit formula _free_fractions_xp /
// _fit_scores_xp (kernels.py:40-79) as the __device__ function fit_score
// of fit.cuh. The plain torch version is bulk_fill_ref in
// tensor/kernels.py.
//
// What it computes (the carry is updated in place):
//   used   += delta at each correction slot's row   (B4's adds)
//   used    = max(used, 0)
//   then per eval g in order:
//   ok      = feas[g] & all(used + ask[g] <= avail)
//   score   = (fit(avail, used + ask) + aff) / (1 + [aff != 0]), NEG if !ok
//   cap     = min(k, max(0, min_{ask_d > 0} floor((avail - used) / ask_d))),
//             0 where score == NEG
//   key     = score + uniform(PRNGKey(seed[g]))[node] x TIE_JITTER
//   order   = nodes by key descending, node index ascending
//   take    = clip(k - exclusive_cumsum(cap in order), 0, cap)
//   used   += ask * take;  counts[g] = take
//
// Bound on the H100: neither bytes nor operations. The bytes are ~0.6 MB
// per launch at N_pad = 16,384 and G = 16 (a fraction of a microsecond of
// HBM time), the operations (two powf, five divisions and a threefry a
// node and eval) a few microseconds at the 32-bit peak of the whole card.
// The time goes to the G evals running one after another on one SM,
// because each reads the carry the previous one wrote.
//
// Design: one launch of one CTA of 1024 threads runs the whole call, so
// the carry chain needs only __syncthreads. The fold's adds are atomics
// into the carry: usage values are integral f32 below 2^24, so every
// partial sum is exact and the order the adds land in does not matter
// (scatter.cu); a slot outside [0, n) is dropped, as XLA's scatter drops
// it. An eval scores the nodes in a coalesced pass (thread t, nodes t, t +
// 1024, ...), skipping the fit and the jitter of a node whose cap is 0 (it
// weighs nothing wherever it falls), and stores each node's order key
// (sort.cuh's desc_key of the key) and cap in the slots of select.cuh's
// positions: node i is position i, held by thread i / kChunk (kChunk a
// power of two, n / 1024 rounded up; one instance a chunk, so the
// selection's loops run over the positions a thread holds). select.cuh's
// threshold_radix finds the level of the cap-weighted prefix (the best
// key's level, else a radix search 8 bits a pass: on the H100 the
// bisection of threshold_select took ~60% of an eval at the C2M width),
// and threshold_base / take_at give each position its take, equal to the
// full stable sort's and scan's; each owner writes its takes over its
// caps, and a second coalesced pass writes the counts and adds the takes
// into the carry. The slot of a thread's q-th position is q x 1024 + (t ^
// swizzle(q)): a warp's reads of one q are 32 consecutive words, and the
// scoring pass's stores (32 consecutive nodes, 1024 / kChunk owners) fall
// in 32 banks too. Keys and caps (6 bytes a slot) live in shared memory up
// to 32,768 nodes, and in a global scratch above
// (nt_bulk_fill_scratch_words; the same algorithm, kShared false).
//
// Arithmetic follows the reference op for op with correctly rounded f32
// division and powf (no fast math, no contraction: built with
// --fmad=false); the jitter is threefry.cuh's, bit for bit B3's. The
// counts and carry equal the plain torch version on the card exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fit.cuh"
#include "select.cuh"
#include "sort.cuh"
#include "threefry.cuh"

namespace {

constexpr int kDims = 4;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1.0e30f;
constexpr int kMaxNodes = 65536;      // B1's node ceiling
constexpr size_t kMaxSmem = 232448;   // a block's shared memory

using nt_fit::fit_score;
using nt_select::kRadixWords;
using nt_select::may_take;
using nt_select::Summary;
using nt_select::summarize;
using nt_select::take_at;
using nt_select::Threshold;
using nt_select::threshold_base;
using nt_select::threshold_radix;
using nt_sort::desc_key;
using nt_threefry::bits_to_unit;
using nt_threefry::threefry_bits;

// positions a thread holds: n / 1024 rounded up to a power of two
__host__ __device__ inline int fill_chunk(int n) {
  int c = 1;
  while (c * kThreads < n) c <<= 1;
  return c;
}

// the slots' bytes: a u32 key and a u16 cap each
__host__ __device__ inline size_t slot_bytes(int n) {
  return (size_t)fill_chunk(n) * kThreads * 6;
}

// the reductions' words (select.cuh: 10 a warp), block_exclusive_scan's (1
// a warp), threshold_radix's histogram
constexpr size_t kWorkBytes = 4 * (11 * kWarps + kRadixWords);

// select.cuh's positions, kChunk a thread, swizzled: thread t's q-th
// position (node t x kChunk + q) in slot q x 1024 + (t ^ swizzle(q)),
// swizzle(q) = q x (32 / kChunk) mod 32 for kChunk <= 32, q mod 32 above
template <int kChunk>
struct FillPositions {
  static constexpr int kMaxQ = kChunk;
  static constexpr int kSpread = kChunk >= 32 ? 1 : 32 / kChunk;
  uint32_t* key;
  uint16_t* cap;
  int n;
  __device__ int count() const {
    const int first = (int)threadIdx.x * kChunk;
    return max(0, min(kChunk, n - first));
  }
  __device__ int slot_of(int t, int q) const {
    return q * kThreads + (t ^ ((q * kSpread) & 31));
  }
  __device__ int slot(int q) const { return slot_of((int)threadIdx.x, q); }
  // the slot of node i
  __device__ int node_slot(int i) const {
    return slot_of(i / kChunk, i % kChunk);
  }
};

template <int kChunk, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
bulk_fill_kernel(float* __restrict__ used, const float* __restrict__ avail,
                 const uint8_t* __restrict__ feas,
                 const float* __restrict__ aff, const float* __restrict__ ask,
                 const int* __restrict__ kk,
                 const long long* __restrict__ seeds,
                 const int* __restrict__ cidx,
                 const float* __restrict__ cdelta,
                 int16_t* __restrict__ counts, uint32_t* __restrict__ scratch,
                 int g, int n, int c, float span) {
  extern __shared__ __align__(16) char smem[];
  uint32_t* red = reinterpret_cast<uint32_t*>(smem);
  int* warp_tot = reinterpret_cast<int*>(red + 10 * kWarps);
  uint32_t* hist = reinterpret_cast<uint32_t*>(warp_tot + kWarps);
  constexpr int slots = kChunk * kThreads;
  uint32_t* keys = kShared ? reinterpret_cast<uint32_t*>(smem + kWorkBytes)
                           : scratch;
  const FillPositions<kChunk> ps{
      keys, reinterpret_cast<uint16_t*>(keys + slots), n};
  const int tid = threadIdx.x;
  for (int i = tid; i < kRadixWords; i += kThreads) hist[i] = 0u;

  // the fold: B4's adds, then the clamp of every row
  for (int t = tid; t < c * kDims; t += kThreads) {
    const int row = cidx[t / kDims];
    if (row >= 0 && row < n) {
      atomicAdd(&used[(long long)row * kDims + t % kDims], cdelta[t]);
    }
  }
  __syncthreads();
  float4* rows = reinterpret_cast<float4*>(used);
  for (int i = tid; i < n; i += kThreads) {
    float4 u = rows[i];
    u.x = fmaxf(u.x, 0.0f);
    u.y = fmaxf(u.y, 0.0f);
    u.z = fmaxf(u.z, 0.0f);
    u.w = fmaxf(u.w, 0.0f);
    rows[i] = u;
  }

  const float4* av4 = reinterpret_cast<const float4*>(avail);
  int parity = 0;
  for (int e = 0; e < g; ++e) {
    const float4 a4 = reinterpret_cast<const float4*>(ask)[e];
    const float a_g[kDims] = {a4.x, a4.y, a4.z, a4.w};
    const int budget = kk[e];
    const float budget_f = (float)budget;
    const uint8_t* feas_g = feas + (long long)e * n;
    const float* aff_g = aff + (long long)e * n;
    const unsigned long long seed = (unsigned long long)seeds[e];
    const uint32_t k0 = (uint32_t)(seed >> 32), k1 = (uint32_t)seed;

    // score, cap and key of every node (each thread's own rows: the
    // carry it reads is the one it wrote at the last eval)
#pragma unroll 2
    for (int j = 0; j < kChunk; ++j) {
      const int i = tid + j * kThreads;
      if (i >= n) break;
      const float4 u4 = rows[i];
      const float4 v4 = av4[i];
      const float u[kDims] = {u4.x, u4.y, u4.z, u4.w};
      const float av[kDims] = {v4.x, v4.y, v4.z, v4.w};
      float nu[kDims];
      bool ok = feas_g[i] != 0;
      float per = INFINITY;
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        nu[d] = __fadd_rn(u[d], a_g[d]);
        ok = ok && (nu[d] <= av[d]);
        if (a_g[d] > 0.0f) {
          per = fminf(per, floorf(__fdiv_rn(__fsub_rn(av[d], u[d]), a_g[d])));
        }
      }
      float cap_f = ok ? fminf(fmaxf(per, 0.0f), budget_f) : 0.0f;
      uint32_t key = 0xffffffffu;  // read by nothing where the cap is 0
      if (cap_f > 0.0f) {
        const float af = aff_g[i];
        const bool aff_present = af != 0.0f;
        const float score = __fdiv_rn(
            __fadd_rn(fit_score(av, nu), aff_present ? af : 0.0f),
            aff_present ? 2.0f : 1.0f);
        if (score > kNeg) {
          const float jit =
              bits_to_unit(threefry_bits(k0, k1, 0u, (uint32_t)i), span);
          key = desc_key(__fadd_rn(score, jit));
        } else {
          cap_f = 0.0f;
        }
      }
      const int s = ps.node_slot(i);
      ps.key[s] = key;
      ps.cap[s] = (uint16_t)(int)cap_f;
    }
    __syncthreads();

    // the takes of this thread's positions, over their caps
    const int m = ps.count();
    if (budget > 0) {
      const Summary sm = summarize(ps, (uint32_t)budget);
      const Threshold th =
          threshold_radix(ps, sm, (uint32_t)budget, hist, red, parity);
      long long excl = threshold_base(ps, sm, th, (uint32_t)budget, warp_tot);
      const bool may = may_take(sm, th);
      for (int q = 0; q < m; ++q) {
        const int s = ps.slot(q);
        ps.cap[s] = may ? (uint16_t)take_at(ps.key[s], ps.cap[s], th,
                                            (uint32_t)budget, excl)
                        : (uint16_t)0;
      }
    } else {
      for (int q = 0; q < m; ++q) ps.cap[ps.slot(q)] = 0;
    }
    __syncthreads();

    // counts and carry, in the scoring pass's order
    int16_t* counts_g = counts + (long long)e * n;
    for (int i = tid; i < n; i += kThreads) {
      const int take = ps.cap[ps.node_slot(i)];
      counts_g[i] = (int16_t)take;
      if (take > 0) {
        const float tf = (float)take;
        float4 u4 = rows[i];
        u4.x = __fadd_rn(u4.x, __fmul_rn(a_g[0], tf));
        u4.y = __fadd_rn(u4.y, __fmul_rn(a_g[1], tf));
        u4.z = __fadd_rn(u4.z, __fmul_rn(a_g[2], tf));
        u4.w = __fadd_rn(u4.w, __fmul_rn(a_g[3], tf));
        rows[i] = u4;
      }
    }
    __syncthreads();  // the slots are the next eval's
  }
}

bool in_smem(int n) { return kWorkBytes + slot_bytes(n) <= kMaxSmem; }

using Kernel = void (*)(float*, const float*, const uint8_t*, const float*,
                        const float*, const int*, const long long*,
                        const int*, const float*, int16_t*, uint32_t*, int,
                        int, int, float);

// the instance for n nodes: its chunk, keys and caps in shared memory up
// to 32 a thread
Kernel kernel_for(int n) {
  switch (fill_chunk(n)) {
    case 1: return bulk_fill_kernel<1, true>;
    case 2: return bulk_fill_kernel<2, true>;
    case 4: return bulk_fill_kernel<4, true>;
    case 8: return bulk_fill_kernel<8, true>;
    case 16: return bulk_fill_kernel<16, true>;
    case 32: return bulk_fill_kernel<32, true>;
    default: return bulk_fill_kernel<64, false>;
  }
}

}  // namespace

// u32 words of nt_bulk_fill's scratch at n nodes: 0 where the slots fit in
// shared memory
extern "C" long long nt_bulk_fill_scratch_words(int n) {
  if (n < 1 || n > kMaxNodes || in_smem(n)) return 0;
  return (long long)(slot_bytes(n) / 4);
}

// used (n, 4) f32, in place; avail (n, 4) f32; feas (g, n) bool; aff (g, n)
// f32; ask (g, 4) f32; k (g,) int32 (each at most 32,767); seeds (g,)
// int64, the PRNGKey seeds; cidx (c,) int32 and cdelta (c, 4) f32, the
// correction slots (null where c is 0); counts (g, n) int16 out; scratch
// nt_bulk_fill_scratch_words(n) u32 words, scratch_words their count (a
// smaller buffer is refused); span: the jitter's width in f32.
extern "C" int nt_bulk_fill(void* used, const void* avail, const void* feas,
                            const void* aff, const void* ask, const void* k,
                            const void* seeds, const void* cidx,
                            const void* cdelta, void* counts, void* scratch,
                            int g, int n, int c, int scratch_words,
                            float span, void* stream) {
  if (g < 0 || n < 1 || n > kMaxNodes || c < 0 ||
      (c > 0 && (cidx == nullptr || cdelta == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (nt_bulk_fill_scratch_words(n) > (long long)scratch_words)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kWorkBytes + (in_smem(n) ? slot_bytes(n) : 0);
  const Kernel kernel = kernel_for(n);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (float*)used, (const float*)avail, (const uint8_t*)feas,
      (const float*)aff, (const float*)ask, (const int*)k,
      (const long long*)seeds, (const int*)cidx, (const float*)cdelta,
      (int16_t*)counts, (uint32_t*)scratch, g, n, c, span);
  return (int)cudaGetLastError();
}
