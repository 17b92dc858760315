// threefry2x32, the generator of jax.random, shared by jitter.cu (B3, B3'),
// bulk_fill.cu (B1's jitter), batch_solve.cu (B5's restart jitter, drawn
// inside its rounds), bulk_scan.cu (B11', the tie-break permutation) and
// sharded.cu (B13's and B14's jitter, drawn inside their loops).
//
// 20 rounds of 32-bit adds, rotates and xors under the key pair (k0, k1),
// with the key schedule injected every four rounds, exactly as
// jax._src.prng.threefry2x32 computes it. Held bit for bit against
// tensor/prng.py threefry2x32 through the kernels that use it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nt_threefry {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// (x0, x1) <- threefry2x32((k0, k1), (x0, x1))
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
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
}

// fold_in(PRNGKey(seed), t): the key pair of one threefry of the counter
// (0, t) under the seed's key (seed >> 32, seed & 0xffffffff), both output
// words kept (no xor)
__device__ __forceinline__ void fold_key(unsigned long long seed, uint32_t t,
                                         uint32_t& k0, uint32_t& k1) {
  k0 = 0u;
  k1 = t;
  threefry2x32((uint32_t)(seed >> 32), (uint32_t)seed, k0, k1);
}

// jax.random's 32-bit draw in partitionable mode: element (x0, x1) of the
// counter hashes to out0 ^ out1
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// jax.random._uniform's float: bits -> [1, 2) - 1, times span, floored at 0
__device__ __forceinline__ float bits_to_unit(uint32_t bits, float span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return fmaxf(0.0f, __fadd_rn(__fmul_rn(f, span), 0.0f));
}

}  // namespace nt_threefry
