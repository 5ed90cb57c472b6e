// The slab route of the probe diagnostics (probe_bounds.cu,
// probe_experiments.cu): what their kernels share.
//
// The TPU tools ran a grid (B4 / bt4, R / RT) with the reads minor and
// held the [S1, bt4] tile of the table in VMEM, fetched once for each bin
// tile and reused by every read tile (bench_probe_bounds.py:122-138,
// bench_probe_r4.py:252-266).  The slab is the Hopper form of that tile,
// as in K2's slab route (csrc/probe_slab.cu): a block owns (a slab of
// b = 16 CH bins, a group of reads), copies the [S1, b] slab of the table
// into dynamic shared memory once with cp.async, and streams its reads'
// hashes through it.  A lane owns one 16-byte chunk of a slab row (16
// bins) and reads its chunk of each probed row with one 16-byte shared
// load.  The diagnostics take any B that is a multiple of 4, so the last
// slab may be ragged, down to one partial chunk: lanes whose chunk lies
// past B read no row and write nothing, and a table whose rows are not
// 16-byte aligned (B not a multiple of 16) is copied 4 bytes at a time.
//
// Counting: zero_bytes adds the zero bytes of a 32-bit word into a packed
// byte counter (4 bins a word, csrc/probe_stage.cuh); a lane flushes its
// counters into the output after at most kFlush hashes, before a byte can
// reach 256.  The first flush of a read writes its counts and a later one
// adds to them; only the lane that owns a (read, chunk) touches it, so no
// atomics.  What bounds it on the H100 is the shared-memory row reads, as
// K2's slab route: 3 rows x b bytes a probed hash from each slab.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "../probe_stage.cuh"

namespace diag_slab {

constexpr int kThreads = 1024;  // 32 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFlush = 255;  // hashes a lane counts between flushes

using taxor::flush_bytes;
using taxor::zero_bytes;

// One 4-byte cp.async from global to shared memory (both 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Copies bins [s0, s0 + 16 CH) below B of every row of the table uint8
// [S1, B] into slab, rows of 16 CH bytes: 16-byte copies where copy16 (B
// a multiple of 16 and the table 16-byte aligned), else 4-byte copies.
// Every thread of the block calls it; it returns after a barrier.
template <int CH>
__device__ __forceinline__ void load_slab(uint8_t* slab,
                                          const uint8_t* __restrict__ table,
                                          int S1, int B, int s0,
                                          bool copy16) {
  constexpr int kRow = 16 * CH;
  if (copy16) {
    const int c = threadIdx.x % CH;
    if (s0 + 16 * c < B)
      for (int row = threadIdx.x / CH; row < S1; row += kThreads / CH)
        taxor::cp_async16(slab + row * kRow + 16 * c,
                          table + (size_t)row * B + s0 + 16 * c);
  } else {
    const int j = threadIdx.x % (4 * CH);
    if (s0 + 4 * j < B)
      for (int row = threadIdx.x / (4 * CH); row < S1;
           row += kThreads / (4 * CH))
        cp_async4(slab + row * kRow + 4 * j,
                  table + (size_t)row * B + s0 + 4 * j);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  __syncthreads();
}

// cnt[4w + j] = byte j of the packed counter k[w]: the counts of a chunk.
__device__ __forceinline__ void unpack16(int* cnt, const uint32_t* k) {
#pragma unroll
  for (int j = 0; j < 16; ++j) cnt[j] = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) flush_bytes(cnt + 4 * w, k[w]);
}

// Writes (add: adds) the counts of a chunk's bins below B into its place
// in the output, dst = &out[r, first bin of the chunk]; `left` = B minus
// that bin.
__device__ __forceinline__ void put16(int32_t* dst, const int* cnt,
                                      int left, bool add) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (4 * q < left) {
      int4 v = make_int4(cnt[4 * q], cnt[4 * q + 1], cnt[4 * q + 2],
                         cnt[4 * q + 3]);
      if (add) {
        const int4 o = d[q];
        v.x += o.x;
        v.y += o.y;
        v.z += o.z;
        v.w += o.w;
      }
      d[q] = v;
    }
  }
}

}  // namespace diag_slab
