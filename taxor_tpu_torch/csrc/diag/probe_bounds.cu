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
// Two routes; the shape picks one (device/diag.slab_bins).
// The slab route (probe_bounds_slab_kernel, slab.cuh): where a [S1, b]
// slab of b = 16-128 bins fits one block's shared memory, a block holds
// it and streams its reads through it in K2's slab schedule
// (csrc/probe_slab.cu), so that each variant is a share of that route: a
// warp takes one read at a time, lane = hash-lane x CH + chunk, the
// 32 / CH hash-lanes take every (32 / CH)-th hash, a lane reads its chunk
// of each row as one 16-byte shared load, and warp shuffles sum the
// hash-lanes' counts before hash-lane 0 writes them.  A hash-lane reads
// its two position words (p16, load1) or one (smem1) from global memory
// through the read-only cache, where K2 reads its 8-byte record.  Bound on
// the H100 by the shared-memory row reads, 3 x B bytes a probed hash.
// The rows route (probe_bounds_kernel), where no slab fits: block = one
// read x 512 bins, each thread owns 4 adjacent bins (one table word) and
// is the only writer of their counts; the modes that read position words
// stage them into shared memory per tile, as the TPU tool read them from
// SMEM.  Bound by the three table words a hash and thread from L2, as
// K2's rows route (csrc/probe.cu).
#include <cuda_runtime.h>

#include <cstdint>

#include "slab.cuh"

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

// The positions and fingerprint of hash h of read r in mode M (row: the
// read's position words).
template <int M>
__device__ __forceinline__ void bound_fields(const uint32_t* __restrict__ row,
                                             uint32_t h, int r, int U, int RT,
                                             uint32_t& p0, uint32_t& p1,
                                             uint32_t& p2, uint32_t& f4) {
  if (M == kP16 || M == kLoad1) {
    const uint32_t w0 = __ldg(row + 2 * h), w1 = __ldg(row + 2 * h + 1);
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
    const uint32_t z = (h * 40503u + (uint32_t)(r % RT) * 2057u) & 0x7FFu;
    p0 = z;
    p1 = (z + 7) & 0x7FFu;
    p2 = (z + 13) & 0x7FFu;
    f4 = 0x01010101u;
  } else {  // kSmem1
    const uint32_t w0 = __ldg(row + 2 * h);
    p0 = w0 & 0xFFFFu;
    p1 = p0;
    p2 = w0 >> 16;
    f4 = 0x01010101u;
  }
}

template <int M, int CH>
__global__ void __launch_bounds__(diag_slab::kThreads, 1)
    probe_bounds_slab_kernel(const uint8_t* __restrict__ table, int S1,
                             int B, bool copy16,
                             const uint32_t* __restrict__ words, int W,
                             const int32_t* __restrict__ n_hash, int R, int U,
                             int RT, int per, int32_t* __restrict__ out) {
  using namespace diag_slab;
  extern __shared__ __align__(16) uint8_t slab[];  // S1 rows of kRow bytes
  constexpr int HL = 32 / CH;                       // hash-lanes of a warp
  constexpr int kRow = 16 * CH;                     // the slab's bins
  constexpr bool kReadsWords = M == kP16 || M == kLoad1 || M == kSmem1;
  const int s0 = blockIdx.x * kRow;
  load_slab<CH>(slab, table, S1, B, s0, copy16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CH, hl = lane / CH;
  const int left = B - s0 - 16 * c;  // bins of the lane's chunk below B
  const uint8_t* mine = slab + 16 * c;
  const int r1 = min(R, (int)(blockIdx.y + 1) * per);
  for (int r = blockIdx.y * per + warp; r < r1; r += kWarps) {
    // a read probes at most the hashes its row of words holds
    const int n = kReadsWords ? min(n_hash[r], W / 2) : n_hash[r];
    const uint32_t* row = words + (size_t)r * W;
    int32_t* dst = out + (size_t)r * B + s0 + 16 * c;
    // every lane runs the same flush rounds (n is the warp's), so the
    // shuffles below see the whole warp
    for (int e0 = 0;; e0 += kFlush * HL) {
      const int e1 = min(n, e0 + kFlush * HL);
      uint32_t k[4] = {0, 0, 0, 0};
      if (left > 0) {
#pragma unroll 4
        for (int e = e0 + hl; e < e1; e += HL) {
          uint32_t p0, p1, p2, f4;
          bound_fields<M>(row, (uint32_t)e, r, U, RT, p0, p1, p2, f4);
          uint4 x = *reinterpret_cast<const uint4*>(mine + p0 * kRow);
          if (M != kLoad1) {
            const uint4 b = *reinterpret_cast<const uint4*>(mine + p1 * kRow);
            const uint4 d = *reinterpret_cast<const uint4*>(mine + p2 * kRow);
            x.x ^= b.x ^ d.x;
            x.y ^= b.y ^ d.y;
            x.z ^= b.z ^ d.z;
            x.w ^= b.w ^ d.w;
          }
          k[0] += zero_bytes(x.x ^ f4);
          k[1] += zero_bytes(x.y ^ f4);
          k[2] += zero_bytes(x.z ^ f4);
          k[3] += zero_bytes(x.w ^ f4);
        }
      }
      int cnt[16];
      unpack16(cnt, k);
#pragma unroll
      for (int off = CH; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          cnt[j] += __shfl_xor_sync(0xFFFFFFFFu, cnt[j], off);
      if (hl == 0 && left > 0) put16(dst, cnt, left, e0 > 0);
      if (e1 >= n) break;
    }
  }
}

template <int M, int CH>
cudaError_t launch_slab(cudaStream_t stream, const void* table, int S1,
                        int B, const void* words, int R, int W,
                        const void* n_hash, int U, int RT, void* out) {
  const auto kern = probe_bounds_slab_kernel<M, CH>;
  const int smem = S1 * 16 * CH;
  const int slabs = (B + 16 * CH - 1) / (16 * CH);
  int per = 0;  // reads a group: one wave of blocks, as K2's slab route
  const cudaError_t err = taxor::slab_read_groups(
      kern, diag_slab::kThreads, smem, slabs, R, 1, per);
  if (err != cudaSuccess) return err;
  const dim3 grid(slabs, (R + per - 1) / per);
  const bool copy16 =
      B % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  kern<<<grid, diag_slab::kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(table), S1, B, copy16,
      static_cast<const uint32_t*>(words), W,
      static_cast<const int32_t*>(n_hash), R, U, RT, per,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <int M>
int launch_mode(int slab_bins, dim3 rows_grid, cudaStream_t s,
                const void* table, int S1, int B, const void* words, int R,
                int W, const void* n_hash, int U, int RT, void* out) {
  switch (slab_bins) {
    case 0:
      launch<M>(rows_grid, s, table, B / 4, words, W, n_hash, U, RT, out);
      return (int)cudaGetLastError();
    case 16:
      return (int)launch_slab<M, 1>(s, table, S1, B, words, R, W, n_hash, U,
                                    RT, out);
    case 32:
      return (int)launch_slab<M, 2>(s, table, S1, B, words, R, W, n_hash, U,
                                    RT, out);
    case 64:
      return (int)launch_slab<M, 4>(s, table, S1, B, words, R, W, n_hash, U,
                                    RT, out);
    case 128:
      return (int)launch_slab<M, 8>(s, table, S1, B, words, R, W, n_hash, U,
                                    RT, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The shared memory a block of CUDA device `device` may opt in to (the
// slab route's limit, device/diag.slab_bins); -1 on a CUDA error.
extern "C" int diag_smem_per_block(int device) {
  int smem = 0;
  if (cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return smem;
}

// table: uint8 [S1, B] (B a multiple of 4); words: int32 [R, W] (p16
// layout, W >= 2 * max n_hash); n_hash: int32 [R]; out: int32 [R, B].
// slab_bins: 16, 32, 64 or 128 for the slab route (an [S1, slab_bins]
// slab must fit a block's shared memory), 0 for the rows route.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad mode or
// slab width.
extern "C" int launch_probe_bounds(const void* table, int S1, int B,
                                   const void* words, int R, int W,
                                   const void* n_hash, int mode, int U,
                                   int RT, int slab_bins, void* out,
                                   void* stream) {
  if (R == 0 || B == 0) return 0;
  const int B4 = B / 4;
  const dim3 grid(R, (B4 + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kP16: return launch_mode<kP16>(slab_bins, grid, s, table, S1, B, words, R, W, n_hash, U, RT, out);
    case kLoad1: return launch_mode<kLoad1>(slab_bins, grid, s, table, S1, B, words, R, W, n_hash, U, RT, out);
    case kNoSmem: return launch_mode<kNoSmem>(slab_bins, grid, s, table, S1, B, words, R, W, n_hash, U, RT, out);
    case kLcg: return launch_mode<kLcg>(slab_bins, grid, s, table, S1, B, words, R, W, n_hash, U, RT, out);
    case kSmem1: return launch_mode<kSmem1>(slab_bins, grid, s, table, S1, B, words, R, W, n_hash, U, RT, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
