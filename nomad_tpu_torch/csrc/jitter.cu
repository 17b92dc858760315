// B3: per-(eval, node) tie-break jitter, threefry2x32 -> U[0, hi).
//
// Replaces: the `jax.random.uniform(jax.random.PRNGKey(s), (n,), f32, 0,
// TIE_JITTER)` draw vmapped over the batch's seeds in
// nomad_tpu/tensor/kernels.py:720-723 (_solve_bulk_multi_impl).
//
// Bound on the H100: memory. Each element is 20 rounds of 32-bit integer
// adds, rotates and xors (~100 integer operations) and one 4-byte store;
// at G=16 x 16,384 that is 1 MB written, a few microseconds of HBM time,
// and the launch itself dominates.
//
// Design: one thread per (eval, node), no shared memory, a grid-stride
// loop. The counter layout is JAX's partitionable mode (counter hi word 0,
// lo word = node index; key = (seed >> 32, seed & 0xffffffff), which is
// (0, seed) for the 32-bit seeds the service ships), the output word is
// out0 ^ out1, and the float is built exactly as jax.random._uniform
// does: bitcast((bits >> 9) | 0x3f800000) - 1, times (hi - lo), plus lo,
// floored at lo (lo = 0 here). Multiplication is explicitly rounded
// (__fmul_rn), so no contraction can change a bit; the result is held
// bit-for-bit against tensor/prng.py:jitter_ref.
//
// B3' (nt_jitter_fold): the joint solve's restart draws,
// `jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(s), t), (n,),
// f32, 0, TIE_JITTER * jscale_t)` in nomad_tpu/tensor/batch_solver.py:319-323,
// for every restart t of the portfolio in one launch: (T, G, n) out.
// fold_in is one more threefry: the key pair is (out0, out1) of the counter
// (0, t) under the seed's key (0, seed), both words kept (no xor). Grid
// row y is one (t, eval) pair, spread over a few CTAs of ~2,048 nodes each:
// a CTA's first thread folds the key once into shared memory, then every
// thread draws its nodes exactly as above under that key. Held
// bit-for-bit against tensor/prng.py:jitter_fold_ref.
//
// Both kernels take a node offset: column i of the output is node
// offset + i. A draw element depends on (key, node index) alone, so a
// node shard draws exactly its slice [offset, offset + n) of the full
// draw (the row slices of nomad_tpu/tensor/sharding.py:246-249, 566-570).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

using nt_threefry::bits_to_unit;
using nt_threefry::fold_key;
using nt_threefry::threefry_bits;

__global__ void jitter_kernel(const uint32_t* __restrict__ seeds,
                              float* __restrict__ out, int g, int n,
                              float span, int offset) {
  const long long total = (long long)g * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(t / n);
    const uint32_t node = (uint32_t)(t - (long long)row * n + offset);
    out[t] = bits_to_unit(threefry_bits(0u, seeds[row], 0u, node), span);
  }
}

// the restarts' draw widths (hi - lo in f32), passed by value
constexpr int kMaxFolds = 8;
struct FoldSpans {
  float v[kMaxFolds];
};

__global__ void jitter_fold_kernel(const uint32_t* __restrict__ seeds,
                                   FoldSpans spans, float* __restrict__ out,
                                   int g, int n, int offset) {
  const int tg = blockIdx.y;  // t * g + row
  const int t = tg / g;
  const int row = tg - t * g;
  __shared__ uint32_t key[2];
  if (threadIdx.x == 0) fold_key(seeds[row], (uint32_t)t, key[0], key[1]);
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const float span = spans.v[t];
  float* dst = out + (long long)tg * n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    dst[i] = bits_to_unit(
        threefry_bits(k0, k1, 0u, (uint32_t)(i + offset)), span);
}

int grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  return (int)(blocks > 65535 ? 65535 : blocks);
}

}  // namespace

extern "C" int nt_jitter(const void* seeds, void* out, int g, int n,
                         float span, int offset, void* stream) {
  const long long total = (long long)g * n;
  if (total <= 0) return 0;
  jitter_kernel<<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seeds, (float*)out, g, n, span, offset);
  return (int)cudaGetLastError();
}

// spans: T host floats, one per restart t = 0..T-1; out: (T, g, n)
extern "C" int nt_jitter_fold(const void* seeds, const float* spans, int t,
                              void* out, int g, int n, int offset,
                              void* stream) {
  if (t < 1 || t > kMaxFolds || g < 1 || (long long)t * g > 65535)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  FoldSpans s{};
  for (int i = 0; i < t; ++i) s.v[i] = spans[i];
  const int threads = 256;
  int blocks_x = (n + threads * 8 - 1) / (threads * 8);  // ~8 nodes a thread
  jitter_fold_kernel<<<dim3(blocks_x, t * g), threads, 0,
                       (cudaStream_t)stream>>>((const uint32_t*)seeds, s,
                                               (float*)out, g, n, offset);
  return (int)cudaGetLastError();
}
