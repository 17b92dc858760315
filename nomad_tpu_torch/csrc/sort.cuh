// The packed-key sort, the block-wide scan and the pairwise tree shared by
// bulk_fill.cu (B1), bulk_scan.cu (B11, B11'), batch_solve.cu (B6's pick)
// and sharded.cu (B13, B14).
//
// desc_key maps a float onto a uint32 whose ascending order is the float's
// descending order, with -0.0 folded onto +0.0 as XLA's sort comparator
// does; packed above a node index, it makes an ascending sort of uint64
// words the stable (key desc, index asc) order of the reference's
// argsort(-key). bitonic_sort sorts a power-of-two count of words in
// shared memory with the whole block; block_exclusive_scan is a prefix sum
// of one int per thread across the block; block_pairwise_sum is the
// reference's fixed-tree sum (kernels._pairwise_sum_xp) over a power-of-two
// count of floats in shared memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nt_sort {

// order-preserving map of a float onto uint32, inverted so that an
// ascending sort of the image is a descending sort of the float
__device__ __forceinline__ uint32_t desc_key(float x) {
  uint32_t b = __float_as_uint(x);
  if (b == 0x80000000u) b = 0u;  // -0.0 sorts with +0.0
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ~ord;
}

__device__ inline void bitonic_sort(uint64_t* s, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = s[i];
          const uint64_t b = s[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// exclusive prefix sum of one int per thread across the block
__device__ inline int block_exclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int t = lane < nw ? warp_tot[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;  // inclusive warp prefix
  }
  __syncthreads();
  const int base = warp > 0 ? warp_tot[warp - 1] : 0;
  const int out = base + incl - v;
  __syncthreads();  // warp_tot is reused by the next call
  return out;
}

// v[i] = v[2i] + v[2i+1] over p (a power of two, at most 2 x kBlock x
// kPer) floats until one is left, by a block of kBlock threads; every level
// reads all its pairs before any write. Returns the sum to every thread;
// tree is clobbered.
template <int kBlock, int kPer>
__device__ inline float block_pairwise_sum(float* tree, int p) {
  for (int half = p >> 1; half >= 1; half >>= 1) {
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kBlock;
      if (i < half) v[j] = __fadd_rn(tree[2 * i], tree[2 * i + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kBlock;
      if (i < half) tree[i] = v[j];
    }
    __syncthreads();
  }
  const float total = tree[0];
  __syncthreads();
  return total;
}

}  // namespace nt_sort
