// B11's wide instances (csrc/bulk_scan.cu states the design): past 8
// resource columns or 8 spreads, or more spreads than the block's warps.
// A translation unit of its own, compiled beside bulk_scan.cu and linked
// into the same library, so that the build's time is not the two sets of
// instances one after another.

#include "../bulk_scan.cuh"

namespace nt_bulk {

ScanKernel wide_kernel(int n, bool cache_in_smem) {
  return scan_kernel_of<true>(n, cache_in_smem);
}

}  // namespace nt_bulk
