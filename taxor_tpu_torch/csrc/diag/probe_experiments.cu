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
//               d2 = (d2 + x) ^ C2 (4 ALU ops a round); each thread adds
//               (d1 ^ d2) >> 31 of its words into extra[r], so the chains
//               cannot be eliminated
//   smemflood   per read, the sum of the position words at index (K*h + u)
//               & 1023 for h < n_hash[r], u < K, into extra[r]: loads and
//               adds alone, no table gather; the counts stay 0
// Every mode but smemflood writes the real counts int32 [R, B]: the TPU
// tool's x modes wrote only bins 0-1 of each word into row 0 and its
// vpux modes folded the chains into row 3; neither artefact is kept.
//
// Layout as K2: a block holds NR reads x 512 bins, each thread 4 adjacent
// bins of each of its reads.  Position words are staged into shared
// memory per tile, as the TPU tool read them from SMEM.  What bounds it on
// the H100: the three table words a hash and thread from L2, plus the
// rounds' ALU work; smemflood is bound by shared-memory loads.
#include <cuda_runtime.h>

#include <cstdint>

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

}  // namespace

// table: uint8 [S1, B] (B a multiple of 4); words: int32 [R, W] (p16: W >=
// 2 * max n_hash; p10: W = H + H/4, H >= max n_hash, H a multiple of 4;
// smemflood: W >= 1024); n_hash: int32 [R]; out: int32 [R, B] and extra:
// int32 [R], both zeroed by the caller.  layout 0 = p16, 1 = p10; nr 1, 2
// or 4; flood_k > 0 runs smemflood with K = flood_k (the other arguments
// but words, W, n_hash and extra unused).
extern "C" int launch_probe_experiment(const void* table, int B,
                                       const void* words, int R, int W, int H,
                                       const void* n_hash, int layout, int nr,
                                       int rounds, int flood_k,
                                       uint32_t block_length, void* out,
                                       void* extra, void* stream) {
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
  const int B4 = B / 4;
  const int key = nr * 2 + (layout == 1);
  switch (key) {
    case 2: launch<1, false>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    case 3: launch<1, true>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    case 4: launch<2, false>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    case 5: launch<2, true>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    case 8: launch<4, false>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    case 9: launch<4, true>(R, B4, s, table, words, W, H, n_hash, block_length, rounds, out, extra); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
