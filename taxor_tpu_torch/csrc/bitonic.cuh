// Block-wide bitonic sort of 64-bit keys in shared or global memory: the
// network of K1 (extract.cu) and of the global-scratch routes of K3
// (dedup.cu) and K4 (sort_pairs.cu), for rows wider than 16,384 keys.
// K3 and K4 sort narrower rows in registers (regsort.cuh).
//
// The counterpart of taxor_tpu/device/pallas_sort.py _bitonic_body, the
// network the TPU kernels ran over lane rotations of a VMEM tile.  Here
// the keys sit in shared memory (or in a global scratch row when they do
// not fit) and each stage is one pass of compare-exchanges over n/2
// pairs, spread over the block's threads, then a barrier.  A (hi, lo)
// pair of u32 sorts lexicographically as the u64 (hi << 32) | lo.
#pragma once
#include <cstdint>

namespace taxor {

constexpr unsigned long long kSentinel = ~0ull;

// Ascending bitonic network over buf[0, n), n a power of two.  Every
// thread of the block calls it; it ends with a barrier.
__device__ inline void bitonic_sort(unsigned long long* buf, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int idx = threadIdx.x; idx < (n >> 1); idx += blockDim.x) {
        const int i = 2 * idx - (idx & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const unsigned long long a = buf[i], b = buf[j];
        if ((a > b) == up) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Smallest power of two >= max(n, 1).
__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace taxor
