// K4's register route, shared by its two sources: the row sort of up to
// 16,384 (hi, lo) pairs on the register network of regsort.cuh, one block
// a row (sort_pairs.cu), or one block a chunk of a longer row, written as
// u64 keys into a scratch row for the merge passes (sort_merge.cu).  Each
// source compiles the instances it launches, in its own nvcc process.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

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

// kKeys = false: block b sorts row b (Wp keys) and writes its first W
// pairs to out_hi / out_lo.  kKeys = true: block b sorts chunk b % chunks
// (Wp = kChunk keys) of row b / chunks, whose pairs start at the chunk's
// offset in the row of W pairs, and writes it as u64 keys to its slot of
// the scratch row `keys` (rows of chunks * Wp keys).
template <int E, bool kVec, bool kKeys>
__global__ void __launch_bounds__(kThreads) sort_pairs_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo, int W,
    int Wp, int chunks, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, unsigned long long* __restrict__ keys) {
  static_assert(E % 4 == 0, "sort_pairs_kernel: E");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  const int t = threadIdx.x;
  const int Ta = max(1, Wp / E);
  const int chunk = kKeys ? (int)(blockIdx.x % chunks) : 0;
  const size_t row = (size_t)(kKeys ? blockIdx.x / chunks : blockIdx.x) * W +
                     (size_t)chunk * Wp;
  const int n_row = W - chunk * Wp;  // pairs of the row from `row` on
  unsigned long long k[E];
  uint4 h[E / 4], l[E / 4];  // every load issued before the first key
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    const int g = (c * Ta + t) * 4;
    const int n = t < Ta ? n_row - g : 0;
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
  if constexpr (kKeys) {  // the whole chunk, sentinels included
    unsigned long long* dst = keys + (size_t)blockIdx.x * Wp;
#pragma unroll
    for (int c = 0; c < E / 4; ++c) {
      const int g = (c * Ta + t) * 4;
      const unsigned long long* s = buf + taxor::reg_slot<E>(g);
      reinterpret_cast<ulonglong2*>(dst + g)[0] = make_ulonglong2(s[0], s[1]);
      reinterpret_cast<ulonglong2*>(dst + g)[1] = make_ulonglong2(s[2], s[3]);
    }
    return;
  }
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

template <int E, bool kKeys>
int launch_registers(const void* hi, const void* lo, int blocks, int W,
                     int Wp, int chunks, void* out_hi, void* out_lo,
                     void* keys, cudaStream_t stream) {
  static_assert(kThreads / 32 <= E, "one transpose covers the warps");
  const int Ta = Wp / E > 1 ? Wp / E : 1;
  const size_t smem = 8 * ((size_t)Ta * E + Ta);  // P keys in their slots
  const bool vec = (W & 3) == 0 && aligned16(hi) && aligned16(lo) &&
                   (kKeys || (aligned16(out_hi) && aligned16(out_lo)));
  const auto kernel = vec ? sort_pairs_kernel<E, true, kKeys>
                          : sort_pairs_kernel<E, false, kKeys>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, Ta > 32 ? Ta : 32, smem, stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo), W, Wp,
      chunks, static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo),
      static_cast<unsigned long long*>(keys));
  return (int)cudaGetLastError();
}

}  // namespace
