// jax.lax.top_k's order as one 64-bit key, and the per-lane and per-warp
// top-R lists built on it, shared by batch_solve.cu (B5) and sharded.cu
// (B14's per-shard bids).
//
// bid_key packs the bid's total-order image (-0.0 below +0.0, as top_k
// orders floats) above the complement of the node index (lower index
// first), so the unique key order is exactly top_k's. 0 is below every
// real key and marks an empty slot.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nt_topr {

constexpr int kTopR = 16;

__device__ __forceinline__ uint64_t bid_key(float v, int idx) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)ord << 32) | (uint64_t)(~(uint32_t)idx);
}

__device__ __forceinline__ float key_val(uint64_t key) {
  const uint32_t ord = (uint32_t)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
}

__device__ __forceinline__ int key_idx(uint64_t key) {
  return (int)(~(uint32_t)key);
}

// keep the kTopR largest keys, descending, in registers
__device__ __forceinline__ void topr_insert(uint64_t (&lst)[kTopR],
                                            uint64_t key) {
  if (key <= lst[kTopR - 1]) return;
  lst[kTopR - 1] = key;
#pragma unroll
  for (int i = kTopR - 1; i > 0; --i) {
    const uint64_t a = lst[i - 1];
    const uint64_t b = lst[i];
    const bool up = b > a;
    lst[i - 1] = up ? b : a;
    lst[i] = up ? a : b;
  }
}

// the warp's kTopR largest keys over its 32 lane lists, into out[]
__device__ __forceinline__ void warp_topr(uint64_t (&lst)[kTopR],
                                          uint64_t* out) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < kTopR; ++j) {
    uint64_t best = lst[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, best, off);
      best = o > best ? o : best;
    }
    if (lane == 0) out[j] = best;
    if (best != 0 && lst[0] == best) {  // keys are unique: one owner pops
#pragma unroll
      for (int i = 0; i < kTopR - 1; ++i) lst[i] = lst[i + 1];
      lst[kTopR - 1] = 0;
    }
  }
}

}  // namespace nt_topr
