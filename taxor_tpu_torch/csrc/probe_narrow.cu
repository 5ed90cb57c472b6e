// K2n: the probe/count of K2 (probe.cu) for narrow tables, Bpad <= 512
// bins (B4 <= 128 words), over a stack of G tables with a per-(g, r)
// activity mask:
//
// counts[g, r, b] = active[g, r] * #{ valid h in read r :
//                   T_g[p0(h), b] ^ T_g[p1(h), b] ^ T_g[p2(h), b] == fprint(h) }
//
// Replaces taxor_tpu/device/pallas_probe.py _kernel_repl (launched by
// _probe_call_repl), the TPU's replicated-row kernel for B4 <= 128: it
// kept 8 hashes in flight, one per sublane, over rows replicated 8 times,
// and reduced the sublanes afterwards.  Here the block's 256 threads split
// into HL hash-lanes x WL word-lanes, WL the power of two >= B4: word-lane
// w owns 4 bins (one 32-bit word of every row) and hash-lane l takes every
// HL-th staged hash.  K2 gives a whole 128-thread block to one 512-bin
// column block, so at the 64-bin root of a hierarchical index 112 of its
// threads idle on every hash; K2n keeps all 256 busy (HL = 16 there).
//
// Counts are int32 per (thread, bin), summed over the hash-lanes through
// shared memory at the end: exact above 256 (no packed byte counters that
// could wrap, cf. _FLUSH_BODIES) and deterministic (no atomics).  Word
// lanes >= B4 (a B4 that is not a power of two) only stage hashes.  An
// inactive (g, r) writes zeros and stages nothing.
//
// What bounds it on the H100: 3 rows x Bpad bytes per valid hash, read by
// one hash-lane as WL consecutive words (64 bytes at the 64-bin root), from
// L2 or HBM, and the dependent load latency, which the hash-lanes hide.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_stage.cuh"

namespace {

constexpr int kThreads = 256;  // hash-lanes x word-lanes
constexpr int kTile = 1024;    // hashes staged per round
constexpr int kMaxB4 = 128;

__global__ void __launch_bounds__(kThreads) probe_count_narrow_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, int R, int H,
    const uint32_t* __restrict__ table, size_t table_words, int B4,
    int wl_shift, const uint8_t* __restrict__ active, uint64_t seed,
    uint32_t bl, int32_t* __restrict__ out) {
  __shared__ int p0[kTile], p1[kTile], p2[kTile];
  __shared__ uint32_t f4[kTile];
  __shared__ int warp_n[kThreads / 32];
  __shared__ int4 part[kThreads];
  const int r = blockIdx.x;
  const size_t gr = (size_t)blockIdx.y * R + r;
  int4* dst = reinterpret_cast<int4*>(out + gr * B4 * 4);
  if (active != nullptr && !active[gr]) {  // uniform over the block
    for (int w = threadIdx.x; w < B4; w += kThreads)
      dst[w] = make_int4(0, 0, 0, 0);
    return;
  }
  table += blockIdx.y * table_words;
  const int WL = 1 << wl_shift, HL = kThreads >> wl_shift;
  const int word = threadIdx.x & (WL - 1);
  const int hlane = threadIdx.x >> wl_shift;
  const size_t row0 = (size_t)r * H;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  int h = 0;  // next slot of the read to stage
  while (h < H) {
    const int n = taxor::stage_probes<kThreads, kTile>(
        hi, lo, valid, row0, H, h, seed, bl, p0, p1, p2, f4, warp_n);
    if (word < B4) {
#pragma unroll 4
      for (int e = hlane; e < n; e += HL) {
        const uint32_t x = table[(size_t)p0[e] * B4 + word] ^
                           table[(size_t)p1[e] * B4 + word] ^
                           table[(size_t)p2[e] * B4 + word] ^ f4[e];
        c0 += (x & 0xFFu) == 0;
        c1 += (x & 0xFF00u) == 0;
        c2 += (x & 0xFF0000u) == 0;
        c3 += (x & 0xFF000000u) == 0;
      }
    }
    __syncthreads();  // the tile is restaged next round
  }
  part[threadIdx.x] = make_int4(c0, c1, c2, c3);
  __syncthreads();
  if (threadIdx.x < B4) {  // threadIdx.x < B4 <= WL: hash-lane 0
    int4 s = part[threadIdx.x];
    for (int l = 1; l < HL; ++l) {
      const int4 q = part[(l << wl_shift) + threadIdx.x];
      s.x += q.x;
      s.y += q.y;
      s.z += q.z;
      s.w += q.w;
    }
    dst[threadIdx.x] = s;
  }
}

}  // namespace

// tables: G contiguous uint8 [S, Bpad] tables, Bpad <= 512; active: uint8
// [G, R] or null (every read active); out: int32 [G, R, Bpad].
extern "C" int launch_probe_count_narrow(const void* hi, const void* lo,
                                         const void* valid, int R, int H,
                                         const void* table, int G, int S,
                                         int Bpad, const void* active,
                                         uint64_t seed,
                                         uint32_t block_length, void* out,
                                         void* stream) {
  const int B4 = Bpad / 4;
  if (B4 > kMaxB4 || B4 <= 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || G == 0) return 0;
  int wl_shift = 0;
  while ((1 << wl_shift) < B4) ++wl_shift;
  const dim3 grid(R, G);
  probe_count_narrow_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), R, H,
      static_cast<const uint32_t*>(table), (size_t)S * B4, B4, wl_shift,
      static_cast<const uint8_t*>(active), seed, block_length,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
