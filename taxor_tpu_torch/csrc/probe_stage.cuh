// Shared by the probe kernels K2 (probe.cu, probe_slab.cu) and K2n
// (probe_narrow.cu).  probe_slots: the probe slots and fingerprint of one
// key, exactly as ixf/xor_filter.compute_probes computes them:
// m = murmur64(h + seed), p_i = reduce32(uint32(rotl64(m, 21 i)), bl) +
// i bl, fprint = uint8(m ^ m >> 32).  stage_probes: a block computes those
// of the valid hash slots of one read into shared memory, compacted in
// slot order with warp ballots, the fingerprint replicated into the 4
// bytes of f4.  cp_async16, zero_bytes and flush_bytes serve the kernels
// that hold a table in shared memory (probe_slab.cu, probe_narrow.cu).
#pragma once
#include <cstdint>

#include "u64.cuh"

namespace taxor {

// The probe slots and the fingerprint byte of one key, as
// ixf/xor_filter.compute_probes computes them.
__device__ __forceinline__ void probe_slots(uint64_t key, uint64_t seed,
                                            uint32_t bl, uint32_t& p0,
                                            uint32_t& p1, uint32_t& p2,
                                            uint32_t& fp) {
  const uint64_t m = murmur64(key + seed);
  p0 = reduce32(m, bl);
  p1 = reduce32(rotl64(m, 21), bl) + bl;
  p2 = reduce32(rotl64(m, 42), bl) + 2 * bl;
  fp = (uint32_t)((m ^ (m >> 32)) & 0xFFu);
}

// One 16-byte cp.async from global to shared memory (both 16-byte
// aligned); the caller commits and waits.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 1 in each byte of x that is zero: bit 7 of (x & 0x7F) + 0x7F | x is
// set unless the byte is 0 (no carry crosses a byte), as the TPU kernels'
// _LOW7 / _SIGN test of pallas_probe.py
__device__ __forceinline__ uint32_t zero_bytes(uint32_t x) {
  return (~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u) >> 7;
}

// cnt[j] += byte j of the packed byte counter k, j < 4
__device__ __forceinline__ void flush_bytes(int* cnt, uint32_t k) {
  cnt[0] += k & 0xFFu;
  cnt[1] += (k >> 8) & 0xFFu;
  cnt[2] += (k >> 16) & 0xFFu;
  cnt[3] += k >> 24;
}

// Stages the valid slots of [h, H) of row `row0` until the next round of
// kThreads slots would overflow kTile; advances h and returns how many
// hashes were staged.  Every thread of the block calls it with the same h.
template <int kThreads, int kTile>
__device__ __forceinline__ int stage_probes(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, size_t row0, int H, int& h,
    uint64_t seed, uint32_t bl, int* p0, int* p1, int* p2, uint32_t* f4,
    int* warp_n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  while (h < H && n + kThreads <= kTile) {
    const int j = h + threadIdx.x;
    const bool v = j < H && valid[row0 + j];
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, v);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int off = n;
    for (int q = 0; q < warp; ++q) off += warp_n[q];
    int total = 0;
    for (int q = 0; q < kThreads / 32; ++q) total += warp_n[q];
    if (v) {
      const int e = off + __popc(ballot & ((1u << lane) - 1));
      const uint64_t key = ((uint64_t)(uint32_t)hi[row0 + j] << 32) |
                           (uint32_t)lo[row0 + j];
      uint32_t q0, q1, q2, fp;
      probe_slots(key, seed, bl, q0, q1, q2, fp);
      p0[e] = (int)q0;
      p1[e] = (int)q1;
      p2[e] = (int)q2;
      f4[e] = fp * 0x01010101u;
    }
    n += total;
    h += kThreads;
    __syncthreads();  // warp_n is rewritten next round
  }
  return n;
}

}  // namespace taxor
