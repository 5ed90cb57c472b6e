// K3: per-read sort and dedup of the emitted canonical k-mers, one block
// per read: the split engine's second kernel (device/e2e.py,
// USE_FUSED_EXTRACT = False), after syncmer_track.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_sort.py _dedup_kernel
// (launched by dedup_fused).  The TPU kernel sentinel-masked the whole
// [rows, W] tile, ran the full-width bitonic network over lane rotations
// in VMEM, and built the unique mask from a rotated copy.  Here a block
// first gathers only the emitted k-mers of its row, in position order,
// into a buffer (a block-wide prefix sum over the emission mask: one
// warp ballot, then the warp totals in shared memory), pads them with
// the all-ones sentinel to a power of two and sorts only that.  The
// sentinel sorts last, so the first hcap slots equal the TPU kernel's.
//
// Outputs per read: kmer int64 [hcap] ascending as u64 (sentinel past the
// emissions), valid (first occurrence, never the sentinel value),
// n_unique over all emissions (an exact shared-memory atomic sum), n_emit.
//
// The buffer holds Wb = next power of two of (L-1)/min_gap + 1, the most
// emissions a row of L positions can hold when emissions are at least
// min_gap apart (hash/device_syncmer.emission_min_gap): 64 KB at
// L = 32768 for k=22/s=12.  Where Wb*8 does not fit shared memory (gap-1
// schemes at L = 32768) the wrapper passes a global scratch row.  A row
// with more than Wb emissions (an input that breaks min_gap) sorts its
// first Wb and reports n_emit = 2^30, so the read falls back to the host
// oracle, as the JAX block compaction's overflow does.
//
// What bounds it on the H100: reading the row's emission mask and its
// emitted k-mers (the traffic of one pass over [R, L]), then
// log2(P)*(log2(P)+1)/2 barrier-separated sort stages over P ~ L/5
// shared-memory keys.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeader = 64;  // warp totals and the unique count
constexpr int kOverflow = 1 << 30;

__global__ void __launch_bounds__(kThreads) dedup_kernel(
    const int64_t* __restrict__ kmer, const uint8_t* __restrict__ emit,
    int L, int hcap, int Wb, unsigned long long* __restrict__ scratch,
    int64_t* __restrict__ out_kmer, uint8_t* __restrict__ out_valid,
    int32_t* __restrict__ n_unique_out, int32_t* __restrict__ n_emit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  int* warp_tot = reinterpret_cast<int*>(smem);
  int* n_unique = warp_tot + kWarps;
  unsigned long long* buf =
      scratch ? scratch + (size_t)r * Wb
              : reinterpret_cast<unsigned long long*>(smem + kHeader);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)r * L;

  // 1. gather the emitted k-mers in position order
  int n = 0;  // emissions before this tile: the same in every thread
  for (int t0 = 0; t0 < L; t0 += kThreads) {
    const int i = t0 + threadIdx.x;
    const bool e = i < L && emit[row + i];
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, e);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int off = n + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_tot[w];
      if (w < warp) off += c;
      n += c;
    }
    if (e && off < Wb) buf[off] = (unsigned long long)kmer[row + i];
    __syncthreads();  // warp_tot is rewritten by the next tile
  }

  // 2. pad to a power of two and sort
  const int m = min(n, Wb);
  const int P = taxor::pow2_at_least(m);
  for (int i = m + threadIdx.x; i < P; i += blockDim.x)
    buf[i] = taxor::kSentinel;
  if (threadIdx.x == 0) *n_unique = 0;
  __syncthreads();
  taxor::bitonic_sort(buf, P);

  // 3. first occurrences, counted over all emissions, then hcap slots
  int local = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    local += (j == 0 || buf[j] != buf[j - 1]) && buf[j] != taxor::kSentinel;
  atomicAdd(n_unique, local);  // integer sum: order-free
  for (int j = threadIdx.x; j < hcap; j += blockDim.x) {
    const size_t o = (size_t)r * hcap + j;
    const unsigned long long v = j < P ? buf[j] : taxor::kSentinel;
    out_kmer[o] = (int64_t)v;
    out_valid[o] = j < m && (j == 0 || v != buf[j - 1]) &&
                   v != taxor::kSentinel;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_unique_out[r] = *n_unique;
    n_emit_out[r] = n > Wb ? kOverflow : n;
  }
}

}  // namespace

extern "C" int launch_dedup(const void* kmer, const void* emit, int R, int L,
                            int hcap, int Wb, void* scratch, void* out_kmer,
                            void* out_valid, void* n_unique, void* n_emit,
                            void* stream) {
  if (R == 0) return 0;
  const size_t smem = kHeader + (scratch ? 0 : (size_t)Wb * 8);
  cudaError_t e = cudaFuncSetAttribute(
      dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dedup_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int64_t*>(kmer), static_cast<const uint8_t*>(emit),
      L, hcap, Wb, static_cast<unsigned long long*>(scratch),
      static_cast<int64_t*>(out_kmer), static_cast<uint8_t*>(out_valid),
      static_cast<int32_t*>(n_unique), static_cast<int32_t*>(n_emit));
  return (int)cudaGetLastError();
}
