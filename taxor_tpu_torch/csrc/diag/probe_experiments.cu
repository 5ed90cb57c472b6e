// Probe experiments: the probe/count with its position words in two
// layouts, with several reads interleaved per thread, with extra
// dependent ALU work per hash, and a loop of position-word loads alone.
//
// Replaces the TPU diagnostic bench_probe_r4.py (call, make_kernel,
// make_smemflood).  Modes:
//   p16 / p10   the real counts from one of two position layouts:
//               p16: words [2h], [2h+1] = p0 | p1 << 16, p2 | f << 16;
//               p10: words [H/4 + h] = o0 | o1 << 10 | o2 << 20 with
//               p_i = i*bl + o_i, and f = byte h%4 of word [h/4]
//   NR = 2, 4   NR reads interleaved per thread (one hash of each in
//               turn): NR independent chains of loads
//   rounds      `rounds` rounds of two dependent chains per hash and table
//               word, seeded from the XOR result, d1 = (d1 ^ x) + C1,
//               d2 = (d2 + x) ^ C2 (4 ALU ops a round); extra[r] gets the
//               sum over the table words of (d1 ^ d2) >> 31, so the chains
//               cannot be eliminated
//   smemflood   per read, the sum of the position words at index (K*h + u)
//               & 1023 for h < n_hash[r], u < K, into extra[r]: loads and
//               adds alone, no table gather; the counts stay 0
// Every mode but smemflood writes the real counts int32 [R, B]: the TPU
// tool's x modes wrote only bins 0-1 of each word into row 0 and its
// vpux modes folded the chains into row 3; neither artefact is kept.
//
// Two routes for the probe modes; the shape picks one
// (device/diag.slab_bins).  smemflood touches no table and has one form.
// The slab route (probe_exp_slab_kernel, slab.cuh): where a [S1, b] slab
// of b = 16-128 bins fits one block's shared memory, a block holds it and
// streams its reads through it.  A lane walks every hash of its reads in
// hash order, as the chains of `rounds` need (d1 and d2 of a read and word
// advance hash by hash; only the sum over the words is free of order):
// lane = read-lane x CH + chunk, so a warp takes 32 / CH read-lanes of NR
// reads each a round, and a lane reads its chunk of each row as one
// 16-byte shared load.  The same layout serves every experiment, with or
// without rounds, so that they compare like with like; its counts need
// no shuffles.  A lane takes its reads' hashes 4 at a time (4 of one read,
// then 4 of the next: NR independent chains of loads) and loads their
// position words from global memory through the read-only cache in
// 16-byte loads where the rows allow it: the 32 / CH read-lanes of a warp
// load from as many rows, so one word a load would take 4 times the L1
// wavefronts (measured on the H100 at 0.215 against 0.146 ms for K2's
// schedule, which loads 8 hashes' words of one read together).  Bound on
// the H100 by the shared-memory row reads, 3 x B bytes a probed hash,
// plus the rounds' ALU work.
// The rows route (probe_exp_kernel), where no slab fits: a block holds NR
// reads x 512 bins, each thread 4 adjacent bins of each of its reads;
// position words are staged into shared memory per tile, as the TPU tool
// read them from SMEM.  Bound by the three table words a hash and thread
// from L2, plus the rounds' ALU work.  smemflood is bound by
// shared-memory loads.
#include <cuda_runtime.h>

#include <cstdint>

#include "slab.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 512;  // hashes per staged tile (a multiple of 4)
constexpr uint32_t kC1 = 0x9E3779B9u;  // -1640531527 as int32
constexpr uint32_t kC2 = 0x85EBCA6Bu;  // -2048144789 as int32

template <int NR, bool P10>
__global__ void __launch_bounds__(kThreads) probe_exp_kernel(
    const uint32_t* __restrict__ table, int B4,
    const uint32_t* __restrict__ words, int W, int H,
    const int32_t* __restrict__ n_hash, int R, uint32_t bl, int rounds,
    int32_t* __restrict__ out, int32_t* __restrict__ extra) {
  __shared__ uint32_t sw[NR][2 * kTile];
  const int r0 = blockIdx.x * NR;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  int n[NR];
  int nmax = 0;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    // a read probes at most the hashes its row of words holds
    n[i] = r0 + i < R ? min(n_hash[r0 + i], P10 ? H : W / 2) : 0;
    nmax = max(nmax, n[i]);
  }
  int c[NR][4];
  uint32_t d1[NR], d2[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0;
    d1[i] = d2[i] = 0;
  }
  for (int h0 = 0; h0 < nmax; h0 += kTile) {
    const int m = min(kTile, nmax - h0);
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      const int mi = min(m, max(0, n[i] - h0));
      const uint32_t* row = words + (size_t)(r0 + i) * W;
      if (P10) {
        for (int j = threadIdx.x; j < mi; j += kThreads)
          sw[i][j] = row[H / 4 + h0 + j];
        for (int j = threadIdx.x; j < (mi + 3) / 4; j += kThreads)
          sw[i][kTile + j] = row[h0 / 4 + j];
      } else {
        for (int j = threadIdx.x; j < 2 * mi; j += kThreads)
          sw[i][j] = row[2 * h0 + j];
      }
    }
    __syncthreads();
    if (col >= B4) continue;
    for (int e = 0; e < m; ++e) {
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (h0 + e >= n[i]) continue;
        uint32_t p0, p1, p2, f4;
        if (P10) {
          const uint32_t w = sw[i][e];
          p0 = w & 1023u;
          p1 = bl + ((w >> 10) & 1023u);
          p2 = 2 * bl + (w >> 20);
          f4 = ((sw[i][kTile + (e >> 2)] >> (8 * (e & 3))) & 0xFFu) *
               0x01010101u;
        } else {
          const uint32_t w0 = sw[i][2 * e], w1 = sw[i][2 * e + 1];
          p0 = w0 & 0xFFFFu;
          p1 = w0 >> 16;
          p2 = w1 & 0xFFFFu;
          f4 = (w1 >> 16) * 0x01010101u;
        }
        const uint32_t x = table[(size_t)p0 * B4 + col] ^
                           table[(size_t)p1 * B4 + col] ^
                           table[(size_t)p2 * B4 + col] ^ f4;
        c[i][0] += (x & 0xFFu) == 0;
        c[i][1] += (x & 0xFF00u) == 0;
        c[i][2] += (x & 0xFF0000u) == 0;
        c[i][3] += (x & 0xFF000000u) == 0;
        for (int q = 0; q < rounds; ++q) {
          d1[i] = (d1[i] ^ x) + kC1;
          d2[i] = (d2[i] + x) ^ kC2;
        }
      }
    }
  }
  if (col >= B4) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    if (r0 + i >= R) continue;
    reinterpret_cast<int4*>(out + (size_t)(r0 + i) * B4 * 4)[col] =
        make_int4(c[i][0], c[i][1], c[i][2], c[i][3]);
    if (rounds > 0) atomicAdd(&extra[r0 + i], (int)((d1[i] ^ d2[i]) >> 31));
  }
}

__global__ void __launch_bounds__(kThreads) smemflood_kernel(
    const uint32_t* __restrict__ words, int W,
    const int32_t* __restrict__ n_hash, int K, int32_t* __restrict__ extra) {
  __shared__ uint32_t sw[1024];
  __shared__ uint32_t total;
  const int r = blockIdx.x;
  const uint32_t* row = words + (size_t)r * W;
  for (int j = threadIdx.x; j < 1024; j += kThreads) sw[j] = row[j];
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  const int n = K * n_hash[r];  // index K*h + u runs over [0, K*n)
  uint32_t acc = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) acc += sw[j & 1023];
  atomicAdd(&total, acc);  // a sum mod 2^32: order-free
  __syncthreads();
  if (threadIdx.x == 0) extra[r] = (int32_t)total;
}

template <int NR, bool P10>
void launch(int R, int B4, cudaStream_t stream, const void* table,
            const void* words, int W, int H, const void* n_hash,
            uint32_t bl, int rounds, void* out, void* extra) {
  const dim3 grid((R + NR - 1) / NR, (B4 + kThreads - 1) / kThreads);
  probe_exp_kernel<NR, P10><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(table), B4,
      static_cast<const uint32_t*>(words), W, H,
      static_cast<const int32_t*>(n_hash), R, bl, rounds,
      static_cast<int32_t*>(out), static_cast<int32_t*>(extra));
}

constexpr int kFlush4 = 252;  // a multiple of the 4 hashes loaded at once

// The position words of hashes e .. e+3 of a read (row: its words; n: the
// hashes it probes, most: the hashes its row holds): p10: w[q] the word of
// hash e+q and w[4] the fingerprint word of all four (e is a multiple of
// 4); p16: w[2q], w[2q+1].  vec: 16-byte loads (aligned rows), taken
// where all four lie inside the row; words of hashes past n are not read.
template <bool P10>
__device__ __forceinline__ void hash_words(const uint32_t* __restrict__ row,
                                           int e, int n, int most, int H,
                                           bool vec, uint32_t* w) {
  if (P10) {
    const uint32_t* pw = row + H / 4 + e;
    if (vec && e + 4 <= most) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(pw));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = e + q < n ? __ldg(pw + q) : 0;
    }
    w[4] = __ldg(row + e / 4);
  } else {
    const uint32_t* pw = row + 2 * e;
    if (vec && e + 4 <= most) {
      const uint4 a = __ldg(reinterpret_cast<const uint4*>(pw));
      const uint4 b = __ldg(reinterpret_cast<const uint4*>(pw) + 1);
      w[0] = a.x;
      w[1] = a.y;
      w[2] = a.z;
      w[3] = a.w;
      w[4] = b.x;
      w[5] = b.y;
      w[6] = b.z;
      w[7] = b.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        w[2 * q] = e + q < n ? __ldg(pw + 2 * q) : 0;
        w[2 * q + 1] = e + q < n ? __ldg(pw + 2 * q + 1) : 0;
      }
    }
  }
}

// CHAINS: rounds > 0 (without, the chains take no registers: 4 reads of a
// lane would spill them)
template <int NR, bool P10, int CH, bool CHAINS>
__global__ void __launch_bounds__(diag_slab::kThreads, 1)
    probe_exp_slab_kernel(const uint8_t* __restrict__ table, int S1, int B,
                          bool copy16, const uint32_t* __restrict__ words,
                          int W, int H, bool vec,
                          const int32_t* __restrict__ n_hash, int R,
                          uint32_t bl, int rounds, int per,
                          int32_t* __restrict__ out,
                          int32_t* __restrict__ extra) {
  using namespace diag_slab;
  extern __shared__ __align__(16) uint8_t slab[];  // S1 rows of kRow bytes
  constexpr int RL = 32 / CH;                       // read-lanes of a warp
  constexpr int kRow = 16 * CH;                     // the slab's bins
  constexpr int kStep = RL * NR;                    // reads of a warp round
  const int s0 = blockIdx.x * kRow;
  load_slab<CH>(slab, table, S1, B, s0, copy16);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CH, rl = lane / CH;
  const int left = B - s0 - 16 * c;  // bins of the lane's chunk below B
  const uint8_t* mine = slab + 16 * c;
  const int r1 = min(R, (int)(blockIdx.y + 1) * per);
  // a read probes at most the hashes its row of words holds
  const int most = P10 ? H : W / 2;
  for (int base = blockIdx.y * per + warp * kStep; base < r1;
       base += kWarps * kStep) {
    const int r0 = base + rl * NR;  // the lane's reads r0 .. r0 + NR - 1
    const uint32_t* row0 = words + (size_t)r0 * W;
    int n[NR];
    int nmax = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      n[i] = r0 + i < r1 && left > 0 ? min(n_hash[r0 + i], most) : 0;
      nmax = max(nmax, n[i]);
    }
    uint32_t d1[CHAINS ? NR : 1][4], d2[CHAINS ? NR : 1][4];
#pragma unroll
    for (int i = 0; i < (CHAINS ? NR : 1); ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) d1[i][j] = d2[i][j] = 0;
    for (int e0 = 0;; e0 += kFlush4) {
      const int e1 = min(nmax, e0 + kFlush4);
      uint32_t k[NR][4];
#pragma unroll
      for (int i = 0; i < NR; ++i) k[i][0] = k[i][1] = k[i][2] = k[i][3] = 0;
      for (int e = e0; e < e1; e += 4) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          if (e >= n[i]) continue;
          uint32_t w[P10 ? 5 : 8];
          hash_words<P10>(row0 + (size_t)i * W, e, n[i], most, H, vec, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (e + q >= n[i]) break;
            uint32_t p0, p1, p2, f4;
            if (P10) {
              p0 = w[q] & 1023u;
              p1 = bl + ((w[q] >> 10) & 1023u);
              p2 = 2 * bl + (w[q] >> 20);
              f4 = ((w[4] >> (8 * q)) & 0xFFu) * 0x01010101u;
            } else {
              p0 = w[2 * q] & 0xFFFFu;
              p1 = w[2 * q] >> 16;
              p2 = w[2 * q + 1] & 0xFFFFu;
              f4 = (w[2 * q + 1] >> 16) * 0x01010101u;
            }
            const uint4 a = *reinterpret_cast<const uint4*>(mine + p0 * kRow);
            const uint4 b = *reinterpret_cast<const uint4*>(mine + p1 * kRow);
            const uint4 d = *reinterpret_cast<const uint4*>(mine + p2 * kRow);
            const uint32_t x[4] = {a.x ^ b.x ^ d.x ^ f4, a.y ^ b.y ^ d.y ^ f4,
                                   a.z ^ b.z ^ d.z ^ f4,
                                   a.w ^ b.w ^ d.w ^ f4};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              k[i][j] += zero_bytes(x[j]);
              if constexpr (CHAINS)
                for (int t = 0; t < rounds; ++t) {
                  d1[i][j] = (d1[i][j] ^ x[j]) + kC1;
                  d2[i][j] = (d2[i][j] + x[j]) ^ kC2;
                }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        if (r0 + i < r1 && left > 0 && (e0 == 0 || e0 < n[i])) {
          int cnt[16];
          unpack16(cnt, k[i]);
          put16(out + (size_t)(r0 + i) * B + s0 + 16 * c, cnt, left, e0 > 0);
        }
      }
      if (e1 >= nmax) break;
    }
    if constexpr (CHAINS) {  // uniform: every lane of the warp reaches it
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        int sum = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * j < left) sum += (int)((d1[i][j] ^ d2[i][j]) >> 31);
#pragma unroll
        for (int off = 1; off < CH; off <<= 1)
          sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
        if (c == 0 && r0 + i < r1 && sum) atomicAdd(&extra[r0 + i], sum);
      }
    }
  }
}

template <int NR, bool P10, int CH>
cudaError_t launch_slab(int R, cudaStream_t stream, const void* table,
                        int S1, int B, const void* words, int W, int H,
                        const void* n_hash, uint32_t bl, int rounds,
                        void* out, void* extra) {
  const auto kern = rounds > 0 ? probe_exp_slab_kernel<NR, P10, CH, true>
                               : probe_exp_slab_kernel<NR, P10, CH, false>;
  const int smem = S1 * 16 * CH;
  const int slabs = (B + 16 * CH - 1) / (16 * CH);
  int per = 0;  // reads a group: one wave of blocks, none under a warp's
  const cudaError_t err = taxor::slab_read_groups(
      kern, diag_slab::kThreads, smem, slabs, R, (32 / CH) * NR, per);
  if (err != cudaSuccess) return err;
  const dim3 grid(slabs, (R + per - 1) / per);
  const bool copy16 =
      B % 16 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0;
  // 16-byte word loads: every row's words of 4 hashes 16-byte aligned
  const bool vec = reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                   W % 4 == 0 && (!P10 || (H / 4) % 4 == 0);
  kern<<<grid, diag_slab::kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(table), S1, B, copy16,
      static_cast<const uint32_t*>(words), W, H, vec,
      static_cast<const int32_t*>(n_hash), R, bl, rounds, per,
      static_cast<int32_t*>(out), static_cast<int32_t*>(extra));
  return cudaGetLastError();
}

template <int NR, bool P10>
int launch_form(int slab_bins, int R, cudaStream_t s, const void* table,
                int S1, int B, const void* words, int W, int H,
                const void* n_hash, uint32_t bl, int rounds, void* out,
                void* extra) {
  switch (slab_bins) {
    case 0:
      launch<NR, P10>(R, B / 4, s, table, words, W, H, n_hash, bl, rounds,
                      out, extra);
      return (int)cudaGetLastError();
    case 16:
      return (int)launch_slab<NR, P10, 1>(R, s, table, S1, B, words, W, H,
                                          n_hash, bl, rounds, out, extra);
    case 32:
      return (int)launch_slab<NR, P10, 2>(R, s, table, S1, B, words, W, H,
                                          n_hash, bl, rounds, out, extra);
    case 64:
      return (int)launch_slab<NR, P10, 4>(R, s, table, S1, B, words, W, H,
                                          n_hash, bl, rounds, out, extra);
    case 128:
      return (int)launch_slab<NR, P10, 8>(R, s, table, S1, B, words, W, H,
                                          n_hash, bl, rounds, out, extra);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table: uint8 [S1, B] (B a multiple of 4); words: int32 [R, W] (p16: W >=
// 2 * max n_hash; p10: W = H + H/4, H >= max n_hash, H a multiple of 4;
// smemflood: W >= 1024); n_hash: int32 [R]; out: int32 [R, B] (zeroed by
// the caller for smemflood; the probe modes write all of it) and extra:
// int32 [R], zeroed by the caller.  layout 0 = p16, 1 = p10; nr 1, 2 or
// 4; flood_k > 0 runs smemflood with K = flood_k (the other arguments
// but words, W, n_hash and extra unused); slab_bins: 16, 32, 64 or 128
// for the slab route (an [S1, slab_bins] slab must fit a block's shared
// memory), 0 for the rows route.
extern "C" int launch_probe_experiment(const void* table, int S1, int B,
                                       const void* words, int R, int W, int H,
                                       const void* n_hash, int layout, int nr,
                                       int rounds, int flood_k,
                                       uint32_t block_length, int slab_bins,
                                       void* out, void* extra, void* stream) {
  if (R == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (flood_k > 0) {
    smemflood_kernel<<<R, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(words), W,
        static_cast<const int32_t*>(n_hash), flood_k,
        static_cast<int32_t*>(extra));
    return (int)cudaGetLastError();
  }
  if (B == 0) return 0;
  const uint32_t bl = block_length;
  switch (nr * 2 + (layout == 1)) {
    case 2: return launch_form<1, false>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    case 3: return launch_form<1, true>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    case 4: return launch_form<2, false>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    case 5: return launch_form<2, true>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    case 8: return launch_form<4, false>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    case 9: return launch_form<4, true>(slab_bins, R, s, table, S1, B, words, W, H, n_hash, bl, rounds, out, extra);
    default: return (int)cudaErrorInvalidValue;
  }
}
