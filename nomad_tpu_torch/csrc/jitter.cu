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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i & 1][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return x0 ^ x1;
}

__global__ void jitter_kernel(const uint32_t* __restrict__ seeds,
                              float* __restrict__ out, int g, int n,
                              float span) {
  const long long total = (long long)g * n;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int row = (int)(t / n);
    const uint32_t node = (uint32_t)(t - (long long)row * n);
    const uint32_t bits = threefry_bits(0u, seeds[row], 0u, node);
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    out[t] = fmaxf(0.0f, __fadd_rn(__fmul_rn(f, span), 0.0f));
  }
}

}  // namespace

extern "C" int nt_jitter(const void* seeds, void* out, int g, int n,
                         float span, void* stream) {
  const long long total = (long long)g * n;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  jitter_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)seeds, (float*)out, g, n, span);
  return (int)cudaGetLastError();
}
