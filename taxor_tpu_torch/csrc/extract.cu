// K1: open canonical syncmer extraction, dedup and wyhash, one block per read;
// and syncmer_track, the first kernel of the split engine.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_extract.py
// (_extract_kernel, launched by syncmer_hashes_fused) together with the
// bitonic network it inlines (taxor_tpu/device/pallas_sort.py
// _bitonic_body).  The TPU kernel had no cheap sequential code, so it
// computed a scan-free sliding argmin, flagged reads whose tied window
// minima made emission history-dependent (n_emit = 2^30) and left them to
// a rescue sub-batch or the host.  Here one thread runs the reference's
// exact stateful tracker (hash/syncmer.py, src/hashing/syncmer.cpp:
// 109-146), so every read is exact and n_emit is always the true count.
//
// Per block (read r):
//   1. all threads stage the read's 2-bit words in shared memory;
//   2. thread 0 runs the tracker over the bases and appends each emitted
//      canonical k-mer to a sort buffer;
//   3. all threads bitonic-sort the buffer (padded with all-ones to a
//      power of two), mark first occurrences, count them and wyhash the
//      first hcap slots.
// Outputs per read: hi/lo (int32 bit patterns of the wyhash) and valid
// for hcap slots in ascending canonical-k-mer order (0/0/false where a
// slot holds no first occurrence), n_unique over all emissions, n_emit.
//
// What bounds it on the H100: the sequential tracker, ~30 dependent
// instructions per base on one thread of each block; the sort and the
// hashing are parallel and small.  The sort buffer holds W = next power
// of two of the most emissions a read of L bases can have (the
// emission-gap bound, hash/device_syncmer.max_emissions): 64 KB at
// L = 32768 for k=22/s=12.  When W*8 does not fit shared memory (gap-1
// schemes at L = 32768) the wrapper passes a global scratch buffer.
//
// Left for later: warp-per-read tracking (split the read at windows with
// a unique minimum, where the tracker state is history-free), several
// reads per block to fill the SMs on short buckets, and a sort over
// registers/warp shuffles instead of block-wide shared-memory stages.
//
// syncmer_track (the split engine, device/e2e.USE_FUSED_EXTRACT = False)
// writes what the tracker sees instead of sorting it: per end position
// the canonical k-mer (int64 [R, L]) and whether it was emitted (bool
// [R, L], false past the read's length), the contract of the plain
// hash/device_syncmer.syncmer_kmers.  Its JAX counterpart is the XLA
// scan device_syncmer.syncmer_kmers, not a Pallas kernel.  Thread 0
// tracks into a shared bit mask; then every thread computes the k-mers
// of its positions from the staged words (they depend on the bases
// alone) and writes both rows, coalesced.  It is bound by the same
// sequential tracker, then by writing 9 bytes per position.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"
#include "tracker.cuh"
#include "u64.cuh"

namespace {

constexpr int kThreads = 256;

// Shared-memory header before the sort buffer: L/16 stream words, a
// 32-entry ring of s-mer values and two counters (16-byte aligned).
__host__ __device__ inline size_t header_bytes(int L) {
  return (size_t)(L / 4) + 32 * 4 + 16;
}

// Stages read r's 2-bit words (L/16 of them) into shared memory.
__device__ inline void stage_read(const uint8_t* packed, int r, int L,
                                  uint32_t* words) {
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (L / 4));
  for (int i = threadIdx.x; i < L / 16; i += blockDim.x) words[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) syncmer_extract_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int k, int s, int t, int hcap, int W,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_valid,
    int32_t* __restrict__ n_unique_out, int32_t* __restrict__ n_emit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ring = words + L / 16;
  int* counters = reinterpret_cast<int*>(ring + 32);  // n_emit, n_unique
  unsigned long long* buf =
      scratch ? scratch + (size_t)r * W
              : reinterpret_cast<unsigned long long*>(smem + header_bytes(L));

  // 1. stage the read
  stage_read(packed, r, L, words);
  if (threadIdx.x == 0) counters[1] = 0;
  __syncthreads();

  // 2. the reference tracker, one thread, appending to the sort buffer
  if (threadIdx.x == 0) {
    const int len = max(0, min(lengths[r], L));
    counters[0] = taxor::track_syncmers(
        words, ring, len, k, s, t, [&](int n, int, uint64_t kmer) {
          if (n < W) buf[n] = kmer;
        });
  }
  __syncthreads();

  // 3. sort, first occurrences, wyhash
  const int n = counters[0];
  const int m = min(n, W);
  const int P = taxor::pow2_at_least(m);
  for (int i = m + threadIdx.x; i < P; i += blockDim.x)
    buf[i] = taxor::kSentinel;
  __syncthreads();
  taxor::bitonic_sort(buf, P);
  int local = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    local += (j == 0 || buf[j] != buf[j - 1]);
  atomicAdd(&counters[1], local);  // integer sum: order-free
  for (int j = threadIdx.x; j < hcap; j += blockDim.x) {
    const size_t o = (size_t)r * hcap + j;
    const bool v = j < m && (j == 0 || buf[j] != buf[j - 1]);
    const uint64_t h = v ? taxor::wyhash64(buf[j]) : 0;
    out_hi[o] = (int32_t)(uint32_t)(h >> 32);
    out_lo[o] = (int32_t)(uint32_t)h;
    out_valid[o] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_unique_out[r] = counters[1];
    n_emit_out[r] = n;
  }
}

// Canonical k-mer ending at base i, bases before 0 read as A: the value
// syncmer_kmers gives at every position (emitted or not).
__device__ inline uint64_t kmer_at(const uint32_t* words, int i, int k) {
  uint64_t f = 0, rv = 0;
  for (int j = 0; j < k; ++j) {
    const int p = i - j;
    const uint32_t c = p >= 0 ? taxor::base_at(words, p) : 0u;
    f |= (uint64_t)c << (2 * j);
    rv |= (uint64_t)(3u - c) << (2 * (k - 1 - j));
  }
  return f < rv ? f : rv;
}

__global__ void __launch_bounds__(kThreads) syncmer_track_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int k, int s, int t, int64_t* __restrict__ out_kmer,
    uint8_t* __restrict__ out_emit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ring = words + L / 16;
  uint32_t* bits = ring + 32;  // emission mask, ceil(L/32) words

  stage_read(packed, r, L, words);
  for (int i = threadIdx.x; i < (L + 31) / 32; i += blockDim.x) bits[i] = 0;
  __syncthreads();
  if (threadIdx.x == 0) {
    const int len = max(0, min(lengths[r], L));
    taxor::track_syncmers(words, ring, len, k, s, t,
                          [&](int, int i, uint64_t) {
                            bits[i >> 5] |= 1u << (i & 31);
                          });
  }
  __syncthreads();
  const size_t row = (size_t)r * L;
  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    out_kmer[row + i] = (int64_t)kmer_at(words, i, k);
    out_emit[row + i] = (bits[i >> 5] >> (i & 31)) & 1u;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int launch_syncmer_extract(const void* packed, const void* lengths,
                                      int R, int L, int k, int s, int t,
                                      int hcap, int W, void* scratch,
                                      void* out_hi, void* out_lo,
                                      void* out_valid, void* n_unique,
                                      void* n_emit, void* stream) {
  if (R == 0) return 0;
  const size_t smem = header_bytes(L) + (scratch ? 0 : (size_t)W * 8);
  cudaError_t e = set_smem((const void*)syncmer_extract_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  syncmer_extract_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, k, s, t, hcap, W,
      static_cast<unsigned long long*>(scratch),
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo),
      static_cast<uint8_t*>(out_valid), static_cast<int32_t*>(n_unique),
      static_cast<int32_t*>(n_emit));
  return (int)cudaGetLastError();
}

extern "C" int launch_syncmer_track(const void* packed, const void* lengths,
                                    int R, int L, int k, int s, int t,
                                    void* out_kmer, void* out_emit,
                                    void* stream) {
  if (R == 0) return 0;
  const size_t smem = (size_t)(L / 4) + 32 * 4 + 4 * (size_t)((L + 31) / 32);
  cudaError_t e = set_smem((const void*)syncmer_track_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  syncmer_track_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, k, s, t,
      static_cast<int64_t*>(out_kmer), static_cast<uint8_t*>(out_emit));
  return (int)cudaGetLastError();
}
