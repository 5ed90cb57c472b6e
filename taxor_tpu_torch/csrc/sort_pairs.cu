// K4: row-wise ascending lexicographic sort of (hi, lo) u32 pairs, one
// block per row.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_sort.py:62 _sort_kernel
// (launched by sort_pairs, pallas_call at :184), which ran the bitonic
// network over a [rows, W] VMEM tile.  Here each row's pairs become u64
// keys (hi << 32) | lo, padded with the all-ones sentinel to Wp, a power
// of two; equal keys are indistinguishable, so the sort needs no
// stability.  Two routes, by Wp:
//   - Wp <= 16,384: the register network of regsort.cuh
//     (sort_pairs_kernel), E = 16 keys a thread (32 at Wp = 16,384), Wp/E
//     threads.  Register 4c + q of thread t takes pair (c*Ta + t)*4 + q
//     of the row: a warp's 16-byte loads of hi and of lo are neighbours
//     (any placement of the keys sorts alike), all issued before the
//     first key is formed (word by word where W is no multiple of 4:
//     the same loop, compiled apart, as a run-time test in it cost 10%).
//     The row sorts in registers; the first W keys go back, split into
//     hi and lo, through one more round trip in shared memory, so that
//     a warp's 16-byte stores are neighbours too
//     (writing thread t's sorted pairs t*E .. from its registers spread
//     a warp's stores 4E bytes apart: on the H100 0.048 against
//     0.026 ms for the loads and stores alone, PERF.md §6).
//   - Wp > 16,384: sort_pairs_scratch_kernel, the network of bitonic.cuh
//     over a global scratch row.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6
// has the runs).  Its bound (chip_smoke.py phase 10) is one read and one
// write of 8 bytes a pair: 0.0200 ms at [512, 8,192].  The shared-memory
// network before this design took 91 passes over 8,192 keys a row, each
// reading and writing 128 KB of shared memory with a barrier: 0.275 ms.
// This one takes ~0.125 ms on the device, and what holds it is moving
// keys between threads, not the bytes: a row's 35 shuffle strides issue
// 17,920 warp shuffles (at one a clock an SM, ~35 us over the 3.9 rows
// an SM takes), its 9 round trips through shared memory (8 for the
// strides across warps, 1 out) 1.1 MB, and with 64 registers a thread
// two 512-thread blocks share an SM, in step, so their loads and stores
// (0.026 ms alone) barely overlap the sort.  Taking out the shuffle
// strides, the transposes or the register strides (wrong results, for
// the count) took 0.054, 0.027 and 0.036 ms off; E = 32 on 256 threads
// was slower (0.165 ms a call against 0.142).

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"
#include "regsort.cuh"

namespace {

// ------------------------------------------------ register-network route
constexpr int kThreads = 512;  // the most threads a row takes

__device__ __forceinline__ unsigned long long join(uint32_t h, uint32_t l) {
  return ((unsigned long long)h << 32) | l;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The n (<= 0: none) words at p, up to 4, all-ones past them.  kVec: the
// row's width is a multiple of 4 and its pointers 16-byte aligned, so n
// is all 4 or none and one 16-byte load takes them; else word by word.
template <bool kVec>
__device__ __forceinline__ uint4 load4(const int32_t* p, int n) {
  if constexpr (kVec) {
    return n > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                 : make_uint4(~0u, ~0u, ~0u, ~0u);
  } else {
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = q < n ? (uint32_t)p[q] : ~0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The first n (up to 4) words of v to p, as load4 reads them.
template <bool kVec>
__device__ __forceinline__ void store4(int32_t* p, int n, uint4 v) {
  if constexpr (kVec) {
    if (n > 0) *reinterpret_cast<uint4*>(p) = v;
  } else {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n) p[q] = (int32_t)w[q];
  }
}

template <int E, bool kVec>
__global__ void __launch_bounds__(kThreads) sort_pairs_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int W,
    int Wp, int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo) {
  static_assert(E % 4 == 0, "sort_pairs_kernel: E");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  const int t = threadIdx.x;
  const int Ta = max(1, Wp / E);
  const size_t row = (size_t)blockIdx.x * W;
  unsigned long long k[E];
  uint4 h[E / 4], l[E / 4];  // every load issued before the first key
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    const int g = (c * Ta + t) * 4;
    const int n = t < Ta ? W - g : 0;
    h[c] = load4<kVec>(hi + row + g, n);
    l[c] = load4<kVec>(lo + row + g, n);
  }
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    k[4 * c] = join(h[c].x, l[c].x);
    k[4 * c + 1] = join(h[c].y, l[c].y);
    k[4 * c + 2] = join(h[c].z, l[c].z);
    k[4 * c + 3] = join(h[c].w, l[c].w);
  }
  taxor::reg_sort<E>(k, Ta, buf);
  // Out through shared memory: thread t holds sorted pairs t*E .. t*E+E-1,
  // so its own 16-byte stores would land 4E bytes apart across a warp;
  // read back striped, pairs (c*Ta + t)*4 .., a warp's stores are
  // neighbours, as its loads were.  Slots as in reg_sort: the four keys
  // of a load are neighbours, the lanes of a warp on distinct banks.
  __syncthreads();
  if (t < Ta) {
#pragma unroll
    for (int j = 0; j < E; ++j) buf[t * (E + 1) + j] = k[j];
  }
  __syncthreads();
  if (t >= Ta) return;
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    const int g = (c * Ta + t) * 4;
    const unsigned long long* s = buf + taxor::reg_slot<E>(g);
    const unsigned long long a = s[0], b = s[1], d = s[2], f = s[3];
    store4<kVec>(out_hi + row + g, W - g,
                 make_uint4((uint32_t)(a >> 32), (uint32_t)(b >> 32),
                            (uint32_t)(d >> 32), (uint32_t)(f >> 32)));
    store4<kVec>(out_lo + row + g, W - g,
                 make_uint4((uint32_t)a, (uint32_t)b, (uint32_t)d,
                            (uint32_t)f));
  }
}

template <int E>
int launch_registers(const void* hi, const void* lo, int R, int W, int Wp,
                     void* out_hi, void* out_lo, cudaStream_t stream) {
  static_assert(kThreads / 32 <= E, "one transpose covers the warps");
  const int Ta = Wp / E > 1 ? Wp / E : 1;
  const size_t smem = 8 * ((size_t)Ta * E + Ta);  // P keys in their slots
  const bool vec = (W & 3) == 0 && aligned16(hi) && aligned16(lo) &&
                   aligned16(out_hi) && aligned16(out_lo);
  const auto kernel =
      vec ? sort_pairs_kernel<E, true> : sort_pairs_kernel<E, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<R, Ta > 32 ? Ta : 32, smem, stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo), W, Wp,
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo));
  return (int)cudaGetLastError();
}

// --------------------------------------------------- global-scratch route
constexpr int kScratchThreads = 1024;

__global__ void __launch_bounds__(kScratchThreads) sort_pairs_scratch_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int W,
    int Wp, unsigned long long* __restrict__ scratch,
    int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo) {
  const int r = blockIdx.x;
  unsigned long long* buf = scratch + (size_t)r * Wp;
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

// scratch: a [R, Wp] u64 row a read where Wp > 16,384, else null.
extern "C" int launch_sort_pairs(const void* hi, const void* lo, int R,
                                 int W, int Wp, void* scratch, void* out_hi,
                                 void* out_lo, void* stream) {
  if (R == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch) {
    sort_pairs_scratch_kernel<<<R, kScratchThreads, 0, s>>>(
        static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo), W,
        Wp, static_cast<unsigned long long*>(scratch),
        static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo));
    return (int)cudaGetLastError();
  }
  if (Wp <= 8192)
    return launch_registers<16>(hi, lo, R, W, Wp, out_hi, out_lo, s);
  if (Wp <= 16384)
    return launch_registers<32>(hi, lo, R, W, Wp, out_hi, out_lo, s);
  return (int)cudaErrorInvalidValue;  // needs the scratch route
}
