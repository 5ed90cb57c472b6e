// K4: row-wise ascending lexicographic sort of (hi, lo) u32 pairs, one
// block per row.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_sort.py _sort_kernel
// (launched by sort_pairs), which ran the bitonic network over a
// [rows, W] VMEM tile.  Here each row's pairs become u64 keys
// (hi << 32) | lo in shared memory (a global scratch row where W*8 does
// not fit), padded with the all-ones sentinel to a power of two; the
// network of bitonic.cuh sorts them and the first W keys are split back.
// Equal keys are indistinguishable, so the sort needs no stability.
//
// What bounds it on the H100: log2(Wp)*(log2(Wp)+1)/2 barrier-separated
// stages over Wp shared-memory keys (91 at W = 8192), against one read
// and one write of 8 bytes per pair.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) sort_pairs_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int W,
    int Wp, unsigned long long* __restrict__ scratch,
    int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  unsigned long long* buf =
      scratch ? scratch + (size_t)r * Wp
              : reinterpret_cast<unsigned long long*>(smem);
  const size_t row = (size_t)r * W;
  for (int i = threadIdx.x; i < Wp; i += blockDim.x)
    buf[i] = i < W ? ((unsigned long long)(uint32_t)hi[row + i] << 32) |
                         (uint32_t)lo[row + i]
                   : taxor::kSentinel;
  __syncthreads();
  taxor::bitonic_sort(buf, Wp);
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    out_hi[row + i] = (int32_t)(uint32_t)(buf[i] >> 32);
    out_lo[row + i] = (int32_t)(uint32_t)buf[i];
  }
}

}  // namespace

extern "C" int launch_sort_pairs(const void* hi, const void* lo, int R,
                                 int W, int Wp, void* scratch, void* out_hi,
                                 void* out_lo, void* stream) {
  if (R == 0 || W == 0) return 0;
  const size_t smem = scratch ? 0 : (size_t)Wp * 8;
  cudaError_t e = cudaFuncSetAttribute(
      sort_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sort_pairs_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo), W, Wp,
      static_cast<unsigned long long*>(scratch),
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo));
  return (int)cudaGetLastError();
}
