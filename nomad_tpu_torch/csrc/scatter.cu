// B4: usage scatter-add, used[idx[b], :] += delta[b, :].
//
// Replaces: `used.at[idx].add(delta)`, the state_scatter / state_fold jits
// of nomad_tpu/tensor/incremental.py:101-117, and the same fold of the
// correction slots at the top of _solve_bulk_multi_impl
// (nomad_tpu/tensor/kernels.py:712).
//
// Bound on the H100: memory, and at the path's sizes (64 correction slots,
// or a few thousand delta rows at a resync) the launch itself. The bytes
// are B x (4 + 2 x 16) plus the touched rows of `used`.
//
// Design: one thread per (row, dim) with atomicAdd into the carry.
// Duplicate rows accumulate. Usage values are integral float32 below 2^24,
// so every partial sum is exact and the result does not depend on the
// order the atomics land in. Padding slots carry (idx 0, delta 0), an
// exact no-op. Rows outside [0, n) are dropped, the same out-of-range
// rule as XLA's scatter.

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_kernel(float* __restrict__ used,
                                   const int* __restrict__ idx,
                                   const float* __restrict__ delta, int b,
                                   int d, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= b * d) return;
  const int row = idx[t / d];
  if (row < 0 || row >= n) return;
  atomicAdd(&used[(long long)row * d + (t % d)], delta[t]);
}

}  // namespace

extern "C" int nt_scatter_add(void* used, const void* idx, const void* delta,
                              int b, int d, int n, void* stream) {
  if (b <= 0) return 0;
  const int threads = 256;
  const int blocks = (b * d + threads - 1) / threads;
  scatter_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)used, (const int*)idx, (const float*)delta, b, d, n);
  return (int)cudaGetLastError();
}
