// K5: minimiser and plain k-mer extraction, one block per (read, tile of
// end positions).
//
// Replaces the XLA graph taxor_tpu/hash/device_syncmer.minimizer_kmers (no
// Pallas kernel): its rolling words (_rolling_packed_words), the van
// Herk/Gil-Werman sliding leftmost minimum over (hi, lo) u32 pairs
// (_sliding_leftmost_min_pair) and the emission masks, some 60-100 tensor
// operations over [R, L] a batch.  The reference's non-syncmer scheme is
// seqan3's minimiser_hash (src/main/taxor_search.cpp:210-212): the value of
// the k-mer ending at base i is min(fwd ^ seed, rc ^ seed) as a uint64,
// seed = adjust_seed(k) (hash/minimizer.py); the holder of a window of w' =
// window - k + 1 values is always its LEFTMOST minimum, so
//
//   emit[i] = i < len and (i == k + w' - 2
//             or (i > k + w' - 2 and argmin(i) != argmin(i - 1)))
//
// and an emission writes the window's minimum.  w' = 1 (window == k) emits
// every position from k - 1 on: the plain canonical k-mers.  Duplicates are
// kept (vector semantics), nothing is hashed.
//
// Per block (read r, end positions [i0, i0 + kTile)):
//   1. stage the 2-bit words of bases [i0 - w' - k + 1, i0 + kTile) in
//      shared memory, bases before 0 as A (zero words);
//   2. each thread computes the canonical values of its positions in
//      [i0 - w', i0 + kTile): two funnel shifts of three staged words, the
//      2-bit reversal of tracker.cuh for the forward strand, the complement
//      for the reverse one, both XOR-ed with the seed, the uint64 minimum
//      (k = 32 sets the seed's top bit, so the compare is unsigned);
//   3. each thread scans the w' values of the windows ending at its
//      positions in [i0 - 1, i0 + kTile) from the oldest rightwards, a
//      strictly smaller value taking over: the leftmost argmin;
//   4. the emission rule above, coalesced writes of hi, lo (int32 bit
//      patterns of the emitted value, 0 where nothing is emitted) and emit
//      (bool [R, L]), and the block's emission count: a warp reduction, a
//      shared-memory sum and one integer atomicAdd into n_emit[r] (exact and
//      order-free; the wrapper zeroes n_emit).
// A tile past the read's length writes zeros and computes nothing.
//
// What bounds it on the H100.  The outputs, 9 bytes a position (hi, lo,
// emit), against a quarter byte a position in: bytes.  The work a position
// is ~20 integer operations for the value and 4 a window element for the
// scan (w' = 7 for the bench's k = 20, window = 26): ~50, far under the
// bytes' time at 67 TFLOP/s.  Shared memory: the staged words, (kTile + w')
// values of 8 bytes and (kTile + 1) argmins, 12,664 bytes at w' = 7.

#include <cuda_runtime.h>

#include <cstdint>

#include "tracker.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // end positions a block

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Staged words of one tile: bases [b0, b0 + 16 * words) with b0 a multiple
// of 16 at or before i0 - w' - k + 1, two more words for the funnel shifts.
__host__ __device__ inline int tile_words(int k, int wp) {
  return (kTile + wp + k + 15) / 16 + 3;
}

struct Layout {
  size_t vals, am, red, total;
};

__host__ __device__ inline Layout smem_layout(int k, int wp) {
  Layout o;
  o.vals = align16((size_t)tile_words(k, wp) * 4);
  o.am = o.vals + (size_t)(kTile + wp) * 8;
  o.red = o.am + align16((size_t)(kTile + 1) * 4);
  o.total = o.red + 16;
  return o;
}

__device__ __forceinline__ int floor_div16(int x) {
  return x >= 0 ? x / 16 : -((15 - x) / 16);
}

__global__ void __launch_bounds__(kThreads) minimizer_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int k, int wp, uint64_t seed, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_emit,
    int32_t* __restrict__ n_emit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int i1 = min(i0 + kTile, L);  // the tile's end positions [i0, i1)
  const int len = max(0, min(lengths[r], L));
  const size_t row = (size_t)r * L;
  if (i0 >= len) {  // past the read: nothing is emitted
    for (int i = i0 + threadIdx.x; i < i1; i += kThreads) {
      out_hi[row + i] = 0;
      out_lo[row + i] = 0;
      out_emit[row + i] = 0;
    }
    return;
  }
  const Layout o = smem_layout(k, wp);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
  unsigned long long* vals =
      reinterpret_cast<unsigned long long*>(smem + o.vals);
  int* am = reinterpret_cast<int*>(smem + o.am);
  int* total = reinterpret_cast<int*>(smem + o.red);
  const int v0 = i0 - wp;          // the first position whose value is read
  const int end = min(i1, len);    // positions at or past len never emit

  // 1. stage the words: word j holds bases 16 (w0 + j) .. 16 (w0 + j) + 15
  const int w0 = floor_div16(v0 - k + 1);
  const int nsw = (end - 16 * w0 + 15) / 16 + 2;
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(packed + row / 4);
  for (int j = threadIdx.x; j < nsw; j += kThreads) {
    const int g = w0 + j;
    sw[j] = g >= 0 && g < L / 16 ? src[g] : 0u;
  }
  if (threadIdx.x == 0) *total = 0;
  __syncthreads();

  // 2. canonical XOR-seeded values of positions [v0, end); those before
  // k - 1 are junk and never reach an emitted window
  const uint64_t kmask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
  for (int p = v0 + threadIdx.x; p < end; p += kThreads) {
    const int q = p - k + 1 - 16 * w0;
    const uint32_t* w = sw + (q >> 4);
    const int sh = 2 * (q & 15);
    const uint32_t lo = __funnelshift_r(w[0], w[1], sh);
    const uint32_t hi = __funnelshift_r(w[1], w[2], sh);
    const uint64_t rc = (~(((uint64_t)hi << 32) | lo) & kmask) ^ seed;
    const uint64_t fwd =
        ((((uint64_t)taxor::rev2_32(lo) << 32) | taxor::rev2_32(hi)) >>
         (64 - 2 * k)) ^
        seed;
    vals[p - v0] = fwd < rc ? fwd : rc;
  }
  __syncthreads();

  // 3. leftmost argmin of the window ending at each i in [i0 - 1, end)
  for (int i = i0 - 1 + threadIdx.x; i < end; i += kThreads) {
    int a = i - wp + 1;
    unsigned long long m = vals[a - v0];
    for (int e = a + 1; e <= i; ++e) {
      const unsigned long long v = vals[e - v0];
      if (v < m) {
        m = v;
        a = e;
      }
    }
    am[i - i0 + 1] = a;
  }
  __syncthreads();

  // 4. emissions, outputs and the block's count
  const int first = k + wp - 2;
  int c = 0;
  for (int i = i0 + threadIdx.x; i < i1; i += kThreads) {
    bool e = false;
    uint64_t v = 0;
    if (i < len && i >= first) {
      const int a = am[i - i0 + 1];
      e = i == first || a != am[i - i0];
      if (e) v = vals[a - v0];
    }
    out_hi[row + i] = (int32_t)(uint32_t)(v >> 32);
    out_lo[row + i] = (int32_t)(uint32_t)v;
    out_emit[row + i] = e;
    c += e;
  }
  c = __reduce_add_sync(0xFFFFFFFFu, c);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(total, c);
  __syncthreads();
  if (threadIdx.x == 0 && *total) atomicAdd(n_emit + r, *total);
}

}  // namespace

// Dynamic shared memory of a K5 block for k and w' = window - k + 1.
extern "C" int minimizer_smem(int k, int wp) {
  return (int)smem_layout(k, wp).total;
}

// n_emit must hold zeros: the blocks add their counts into it.
extern "C" int launch_minimizer(const void* packed, const void* lengths,
                                int R, int L, int k, int wp,
                                unsigned long long seed, void* out_hi,
                                void* out_lo, void* out_emit, void* n_emit,
                                void* stream) {
  if (R == 0 || L == 0) return 0;
  const size_t smem = smem_layout(k, wp).total;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)minimizer_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(R, (L + kTile - 1) / kTile);
  minimizer_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, k, wp, (uint64_t)seed,
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo),
      static_cast<uint8_t*>(out_emit), static_cast<int32_t*>(n_emit));
  return (int)cudaGetLastError();
}
