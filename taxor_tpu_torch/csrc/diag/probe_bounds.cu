// Probe bounds: variants of the probe/count that leave out part of the
// per-hash work on purpose, to measure that part's share of the probe's
// time.  Every variant but p16 gives wrong counts by design.
//
// Replaces the TPU diagnostic bench_probe_bounds.py (call, make_kernel),
// whose modes are transcribed here.  Per read r, per hash h < n_hash[r]
// (words of the p16 layout: w0 = p0 | p1 << 16, w1 = p2 | f << 16):
//   p16     p0, p1, p2, f from w0 and w1: the real count
//   load1   one table row: x = T[p0] ^ f4
//   nosmem  no position words read: p = 1+u, 2+u, 3+u with u = h mod U,
//           f = 1
//   lcg     positions from the indices only: z = (h*40503 + r'*2057) &
//           0x7FF with r' = r mod RT (the read's index inside the TPU
//           tool's read tile), p = z, (z+7) & 0x7FF, (z+13) & 0x7FF, f = 1
//   smem1   one position word read: p0 = p1 = w0 & 0xFFFF, p2 = w0 >> 16,
//           f = 1
// and counts[r, b] += [byte b%4 of x is 0] for x = T[p0] ^ T[p1] ^ T[p2] ^
// f4 (f4 = f * 0x01010101, 32-bit).  The table T is uint8 [S1, B] read as
// 32-bit words; the counts are int32 [R, B], bin-major, where the TPU
// tool wrote 4 bins a word into [R, 4, B4].
//
// Layout as K2 (probe.cu): block = one read x 512 bins, each thread owns 4
// adjacent bins (one table word) and is the only writer of their counts.
// The modes that read position words stage them into shared memory per
// tile, as the TPU tool read them from SMEM.  What bounds it on the H100:
// the three table words a hash and thread, from L2 (a 1.2 MB table at the
// tool's geometry), as K2.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // hashes whose words are staged per round

enum Mode { kP16 = 0, kLoad1 = 1, kNoSmem = 2, kLcg = 3, kSmem1 = 4 };

template <int M>
__global__ void __launch_bounds__(kThreads) probe_bounds_kernel(
    const uint32_t* __restrict__ table, int B4,
    const uint32_t* __restrict__ words, int W,
    const int32_t* __restrict__ n_hash, int U, int RT,
    int32_t* __restrict__ out) {
  __shared__ uint32_t sw[2 * kTile];
  constexpr bool kReadsWords = M == kP16 || M == kLoad1 || M == kSmem1;
  const int r = blockIdx.x;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  // a read probes at most the hashes its row of words holds
  const int n = kReadsWords ? min(n_hash[r], W / 2) : n_hash[r];
  const uint32_t* row = words + (size_t)r * W;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int h0 = 0; h0 < n; h0 += kTile) {
    const int m = min(kTile, n - h0);
    if (kReadsWords) {
      __syncthreads();  // the previous tile is no longer read
      for (int i = threadIdx.x; i < 2 * m; i += kThreads)
        sw[i] = row[2 * h0 + i];
      __syncthreads();
    }
    if (col >= B4) continue;
    for (int e = 0; e < m; ++e) {
      const uint32_t h = (uint32_t)(h0 + e);
      uint32_t p0, p1, p2, f4;
      if (M == kP16 || M == kLoad1) {
        const uint32_t w0 = sw[2 * e], w1 = sw[2 * e + 1];
        p0 = w0 & 0xFFFFu;
        p1 = w0 >> 16;
        p2 = w1 & 0xFFFFu;
        f4 = (w1 >> 16) * 0x01010101u;
      } else if (M == kNoSmem) {
        const uint32_t u = h % (uint32_t)U;
        p0 = 1 + u;
        p1 = 2 + u;
        p2 = 3 + u;
        f4 = 0x01010101u;
      } else if (M == kLcg) {
        const uint32_t z =
            (h * 40503u + (uint32_t)(r % RT) * 2057u) & 0x7FFu;
        p0 = z;
        p1 = (z + 7) & 0x7FFu;
        p2 = (z + 13) & 0x7FFu;
        f4 = 0x01010101u;
      } else {  // kSmem1
        const uint32_t w0 = sw[2 * e];
        p0 = w0 & 0xFFFFu;
        p1 = p0;
        p2 = w0 >> 16;
        f4 = 0x01010101u;
      }
      uint32_t x = table[(size_t)p0 * B4 + col] ^ f4;
      if (M != kLoad1)
        x ^= table[(size_t)p1 * B4 + col] ^ table[(size_t)p2 * B4 + col];
      c0 += (x & 0xFFu) == 0;
      c1 += (x & 0xFF00u) == 0;
      c2 += (x & 0xFF0000u) == 0;
      c3 += (x & 0xFF000000u) == 0;
    }
  }
  if (col < B4)
    reinterpret_cast<int4*>(out + (size_t)r * B4 * 4)[col] =
        make_int4(c0, c1, c2, c3);
}

template <int M>
void launch(dim3 grid, cudaStream_t stream, const void* table, int B4,
            const void* words, int W, const void* n_hash, int U, int RT,
            void* out) {
  probe_bounds_kernel<M><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), B4,
      static_cast<const uint32_t*>(words), W,
      static_cast<const int32_t*>(n_hash), U, RT,
      static_cast<int32_t*>(out));
}

}  // namespace

// table: uint8 [S1, B] (B a multiple of 4); words: int32 [R, W] (p16
// layout, W >= 2 * max n_hash); n_hash: int32 [R]; out: int32 [R, B].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad mode.
extern "C" int launch_probe_bounds(const void* table, int B, const void* words,
                                   int R, int W, const void* n_hash, int mode,
                                   int U, int RT, void* out, void* stream) {
  if (R == 0 || B == 0) return 0;
  const int B4 = B / 4;
  const dim3 grid(R, (B4 + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kP16: launch<kP16>(grid, s, table, B4, words, W, n_hash, U, RT, out); break;
    case kLoad1: launch<kLoad1>(grid, s, table, B4, words, W, n_hash, U, RT, out); break;
    case kNoSmem: launch<kNoSmem>(grid, s, table, B4, words, W, n_hash, U, RT, out); break;
    case kLcg: launch<kLcg>(grid, s, table, B4, words, W, n_hash, U, RT, out); break;
    case kSmem1: launch<kSmem1>(grid, s, table, B4, words, W, n_hash, U, RT, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
