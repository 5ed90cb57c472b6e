// K6: the first occurrences of rows of (hi, lo) u32 pairs sorted in u64
// order, the union step of a long read's pieces (device/sort.py
// union_pieces: K1 on the pieces, their valid hashes in one row, K4 sorts
// it, K6 keeps each value once).
//
// No TPU kernel: the JAX package hashes reads past L_CAP on the host
// (taxor_tpu/search/pipeline.py), whose np.unique this replaces.
//
// Per row r: slot j is valid iff j < n_valid[r] and it differs from slot
// j - 1 (j == 0 is always new); hi/lo are copied where valid and 0
// elsewhere (K1's contract), n_unique[r] counts the valid slots.  The
// first n_valid slots are the row's real keys: K4 pads with the all-ones
// sentinel, which a real hash can equal, so a slot past n_valid is never
// compared, and one before it never with a sentinel.
//
// A grid of (chunks of kThreads * kPer slots, rows): each thread loads
// kPer neighbouring slots and the one before them, writes 9 bytes a slot
// and adds its count into a warp sum, then one atomicAdd a warp
// (integers: order-free).  It moves 8 bytes in and 9 out a slot, so its
// bytes bound it; n_unique is zeroed by the launcher first.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;  // slots a thread

__global__ void __launch_bounds__(kThreads) unique_pairs_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ n_valid, int W, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_valid,
    int32_t* __restrict__ n_unique) {
  const int r = blockIdx.y;
  const size_t row = (size_t)r * W;
  const int nv = min(max(n_valid[r], 0), W);
  const int j0 = (blockIdx.x * kThreads + threadIdx.x) * kPer;
  int c = 0;
  if (j0 < W) {
    uint32_t ph = 0, pl = 0;
    if (j0 > 0) {
      ph = (uint32_t)hi[row + j0 - 1];
      pl = (uint32_t)lo[row + j0 - 1];
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = j0 + q;
      if (j >= W) break;
      const uint32_t h = (uint32_t)hi[row + j], l = (uint32_t)lo[row + j];
      const bool v = j < nv && (j == 0 || h != ph || l != pl);
      out_hi[row + j] = v ? (int32_t)h : 0;
      out_lo[row + j] = v ? (int32_t)l : 0;
      out_valid[row + j] = v;
      c += v;
      ph = h;
      pl = l;
    }
  }
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, d);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(&n_unique[r], c);
}

}  // namespace

extern "C" int launch_unique_pairs(const void* hi, const void* lo,
                                   const void* n_valid, int R, int W,
                                   void* out_hi, void* out_lo,
                                   void* out_valid, void* n_unique,
                                   void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(n_unique, 0, (size_t)R * 4, s);
  if (e != cudaSuccess || W == 0) return (int)e;
  const int per_block = kThreads * kPer;
  const dim3 grid((W + per_block - 1) / per_block, R);
  unique_pairs_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(n_valid), W, static_cast<int32_t*>(out_hi),
      static_cast<int32_t*>(out_lo), static_cast<uint8_t*>(out_valid),
      static_cast<int32_t*>(n_unique));
  return (int)cudaGetLastError();
}
