// Register-resident block bitonic sort of 64-bit keys: the network of K3
// (dedup.cu) and K4 (sort_pairs.cu) where a row fits the block's
// registers (P <= 16,384 keys).  K1 (extract.cu) and the global-scratch
// routes of K3 and K4 keep the shared-memory network of bitonic.cuh.
//
// The same compare-exchange network as taxor_tpu/device/pallas_sort.py
// _bitonic_body (and bitonic.cuh): merges of size 2, 4, ..., P, each a
// run of strides size/2, ..., 1; the pair (i, i ^ d) of a stride d is
// ascending iff (i & size) == 0.  What differs is where the keys sit.
// bitonic.cuh keeps them in shared memory and pays one pass over all P
// keys and a barrier for every one of the log2(P)(log2(P)+1)/2 strides
// (91 at P = 8,192).  Here thread t of the first Ta threads holds E keys
// in registers, k[j] the key of index i = t*E + j ("layout A"):
//
//   d < E         both keys are registers of one thread;
//   E <= d < 32E  the partner is lane ^ (d/E) of the same warp:
//                 __shfl_xor_sync on the 64-bit key, each side keeping
//                 the min or the max;
//   d >= 32E      the partner is in another warp.  Only merges of size
//                 2^s > 32E have such strides, s - log2(E) - 5 = w of
//                 them, and w <= log2(E) (P <= E*E*32).  One store to
//                 shared memory in layout A and one load in layout B(w)
//                 swap index bits [0, w) (low register bits) with
//                 [log2(E)+5, log2(E)+5+w) (low warp bits), so those w
//                 strides are register strides; one store and load back
//                 to layout A follow.  A merge pays two such round trips,
//                 not one pass a stride: 8 at P = 8,192, E = 16, where
//                 bitonic.cuh takes 91 passes.
//
// The direction of every compare-exchange comes from the global index of
// its keys in the layout they sit in at that step; in layout B(w) the
// bit that decides it, (i & size), is bit w of the warp.  Shared memory
// holds index i at slot i + i/E (reg_slot): one spare key every E keeps
// the 32 lanes of a warp, E keys apart in both layouts, on distinct
// banks.  Keys compare as unsigned 64-bit values, so the all-ones
// sentinel sorts last.  tests/test_torch_regsort.py holds a numpy
// transcription of this schedule, with the index each (thread, register)
// holds at every step, against np.sort and the JAX Pallas sort.
#pragma once
#include <cstdint>

#include "bitonic.cuh"

namespace taxor {

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n >> 1);
}

// The shared-memory slot of key index i.
template <int E>
__device__ __forceinline__ int reg_slot(int i) {
  constexpr int e = ilog2(E);
  return i + (i >> e);
}

// a holds the lower index of the pair: it keeps the smaller key where the
// pair is ascending.
__device__ __forceinline__ void compare_exchange(unsigned long long& a,
                                                 unsigned long long& b,
                                                 bool up) {
  const unsigned long long x = a, y = b;
  const bool swap = (x > y) == up;
  a = swap ? y : x;
  b = swap ? x : y;
}

// The W strides of a merge that cross warps (W = log2(size) - log2(E) -
// 5): store layout A, load layout B(W), W register strides, store B(W),
// load A.  Layout B(W) swaps index bits [0, W) (low register bits) with
// [e+5, e+5+W) (low warp bits):
//   i = (warp >> W) << (e+5+W) | (j & lo) << (e+5) | lane << e
//       | (j >> W) << W | (warp & lo),                     lo = 2^W - 1.
// The thread's bits (base) and the register's (off) never overlap, nor
// do their low e bits carry, so reg_slot(base + off) = reg_slot(base) +
// off + off/E: with W a compile-time constant every access is the
// thread's slot plus a constant.  The direction, (i & size) == 0, is bit
// W of the warp.  Begins with a barrier, so buf may still be read before.
template <int E, int W>
__device__ __forceinline__ void cross_warp(unsigned long long (&k)[E],
                                           int Ta, unsigned long long* buf) {
  constexpr int e = ilog2(E), lo = (1 << W) - 1;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base =
      ((warp >> W) << (e + 5 + W)) | (lane << e) | (warp & lo);
  unsigned long long* const a_row = buf + t * (E + 1);  // reg_slot(t*E)
  unsigned long long* const b_row = buf + reg_slot<E>(base);
  const bool active = t < Ta;
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < E; ++j) a_row[j] = k[j];
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int off = ((j & lo) << (e + 5)) | ((j >> W) << W);
      k[j] = b_row[off + (off >> e)];
    }
    const bool up = ((warp >> W) & 1) == 0;
#pragma unroll
    for (int c = W - 1; c >= 0; --c) {
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (!(j & (1 << c))) compare_exchange(k[j], k[j | (1 << c)], up);
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int off = ((j & lo) << (e + 5)) | ((j >> W) << W);
      b_row[off + (off >> e)] = k[j];
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int j = 0; j < E; ++j) k[j] = a_row[j];
  }
}

// cross_warp<E, w> for a w known only at run time (1 <= w <= log2(E)).
template <int E, int W = 1>
__device__ __forceinline__ void cross_warp_at(unsigned long long (&k)[E],
                                              int w, int Ta,
                                              unsigned long long* buf) {
  if constexpr (W <= ilog2(E)) {
    if (w == W)
      cross_warp<E, W>(k, Ta, buf);
    else
      cross_warp_at<E, W + 1>(k, w, Ta, buf);
  }
}

// Sorts the P = Ta*E keys that threads 0 .. Ta-1 hold in layout A,
// ascending, into layout A.  Ta is a power of two with Ta/32 <= E.
// Every thread of the block calls it: where Ta > 32 it holds barriers,
// and buf must hold P + P/E keys (the slots of P keys).  Threads of a
// warp with an active thread run the shuffles (lanes past Ta on keys
// that never meet an active lane's); the other warps only join the
// barriers.
template <int E>
__device__ void reg_sort(unsigned long long (&k)[E], int Ta,
                         unsigned long long* buf) {
  constexpr int e = ilog2(E);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int P = Ta * E;
  const bool run = warp * 32 < Ta;
  for (int size = 2; size <= P; size <<= 1) {
    int d = size >> 1;
    if (d >= 32 * E) {  // strides across warps: registers of layout B(w)
      cross_warp_at<E>(k, __ffs(size) - 1 - e - 5, Ta, buf);
      d = 16 * E;
    }
    if (!run) continue;
    const bool up_t = ((t * E) & size) == 0;  // size > d >= E below
    for (; d >= E; d >>= 1) {  // strides across lanes: shuffles
      const int m = d >> e;
      const bool keep_min = ((lane & m) == 0) == up_t;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const unsigned long long p = __shfl_xor_sync(0xFFFFFFFFu, k[j], m);
        if ((p < k[j]) == keep_min) k[j] = p;
      }
    }
#pragma unroll
    for (int c = e - 1; c >= 0; --c) {  // strides inside a thread
      const int dr = 1 << c;
      if (dr < size) {
#pragma unroll
        for (int j = 0; j < E; ++j)
          if (!(j & dr))
            compare_exchange(k[j], k[j | dr], ((t * E + j) & size) == 0);
      }
    }
  }
}

}  // namespace taxor
