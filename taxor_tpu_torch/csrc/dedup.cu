// K3: per-read sort and dedup of the emitted canonical k-mers, one block
// per read: the split engine's second kernel (device/e2e.py,
// USE_FUSED_EXTRACT = False), after syncmer_track.
//
// Replaces the TPU kernel taxor_tpu/device/pallas_sort.py:68
// _dedup_kernel (launched by dedup_fused, pallas_call at :127).  The TPU
// kernel sentinel-masked the whole [rows, W] tile, ran the full-width
// bitonic network over lane rotations in VMEM, and built the unique mask
// from a rotated copy.  Here a block sorts only the emitted k-mers of its
// row, padded with the all-ones sentinel to a power of two P; the
// sentinel sorts last, so the first hcap slots equal the TPU kernel's.
//
// Outputs per read: kmer int64 [hcap] ascending as u64 (sentinel past the
// emissions), valid (first occurrence, never the sentinel value),
// n_unique over all emissions, n_emit.  The buffer holds Wb = next power
// of two of (L-1)/min_gap + 1, the most emissions a row of L positions
// can hold when emissions are at least min_gap apart
// (hash/device_syncmer.emission_min_gap).  A row with more than Wb
// emissions (an input that breaks min_gap) sorts its first Wb in position
// order and reports n_emit = 2^30, so the read falls back to the host
// oracle, as the JAX block compaction's overflow does.
//
// Two routes, by Wb:
//   - Wb <= 16,384: the register network of regsort.cuh (dedup_kernel).
//     1. Gather in one pass: thread t takes a contiguous run of up to 128
//        positions and loads its emit bytes in 16-byte words (byte by
//        byte where L is no multiple of 16), every load issued before
//        the first barrier, with the first 8 emitted k-mers of the
//        run; one block-wide exclusive scan of the run counts
//        (warp scans by shuffle, warp totals in shared memory, two
//        barriers) gives each emission its offset, in position order,
//        and the k-mers land in shared memory (slot i + i/E).  A row past
//        128 x T positions takes one such pass per 128 x T.
//     2. Sort only the row's own keys: P = pow2(m) of its m emissions,
//        E keys a thread (E fixed per launch by Wb), so the row takes
//        P/E active threads; the other warps only join the barriers.
//     3. Unique flags from registers: a key's predecessor is the
//        thread's previous register, lane-1's last key (__shfl_up_sync)
//        or the previous warp's last key (shared memory); n_unique is a
//        warp reduce, then one shared-memory add a warp.
//     4. The hcap slots are written from registers (16-byte stores of
//        key pairs, 8 flags a word where hcap % 8 == 0), the sentinel
//        past P by the whole block, coalesced.
//   - Wb > 16,384 (gap-1 schemes at L = 32,768: 256 KB of keys, more than
//     a block's shared memory): dedup_scratch_kernel, the network of
//     bitonic.cuh over a global scratch row, with a tiled gather.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6
// has the runs).  Its bound (chip_smoke.py phase 10) counts what the
// function must move: the emit row read whole (a byte a position), the
// 32-byte sectors that hold the k-mers of the first Wb emissions (the
// memory's least transfer; emissions lie at least 8 x min_gap bytes
// apart), the hcap slots (9 bytes each) and the counts written: 0.0065
// ms at R = 512, L = 8,192, of which the slots written are 9.4 of 21.9
// MB.  The shared-memory network before this design took 45-55 passes
// over P keys a row, each with a barrier, and the gather 32 tiles of 256
// positions, each a dependent global load, a ballot and two barriers:
// 0.050 ms on the device, 13% of that bound.  This one takes ~0.020 ms,
// ~32%: the gather and the writes alone (emit all false) 0.009 ms, twice
// their own 0.0041 ms of bytes; the rest is the sort of P = 512-1,024
// keys a row (random reads of the L = 8,192 bucket emit 352-728 k-mers),
// of which the shuffle strides take the most.  Staging the outputs
// through shared memory for coalesced stores, as K4 does, gained 5% and
// was not kept.  The byte-load form of the gather (kVec false) is
// compiled apart: a run-time test in the same loop cost 6% on the search
// paths' rows.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"
#include "regsort.cuh"

namespace {

constexpr int kOverflow = 1 << 30;

// ------------------------------------------------ register-network route
constexpr int kHeader = 512;  // warp totals, n_unique; each warp's last key
constexpr int kRunWords = 4;  // a thread's run: at most 4 x 32 positions
constexpr int kBatch = 8;     // emitted k-mers loaded together

// Four emit bytes (bool: 0 or 1) -> four bits.
__device__ __forceinline__ unsigned emit_bits(unsigned w) {
  w = __vcmpne4(w, 0u) & 0x01010101u;
  return (w | (w >> 7) | (w >> 14) | (w >> 21)) & 0xFu;
}

// The n (<= 0: none) emit bytes at p, up to 16.  kVec: the row's width
// L is a multiple of 16 (every row of the search paths, whose L is a
// power-of-two bucket) and emit 16-byte aligned, so n is all 16 or none
// and one 16-byte load takes them; else byte by byte.
template <bool kVec>
__device__ __forceinline__ uint4 load_emit16(const uint8_t* p, int n) {
  if constexpr (kVec) {
    return n > 0 ? __ldg(reinterpret_cast<const uint4*>(p))
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (q < n) w[q >> 2] |= (unsigned)p[q] << (8 * (q & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Loads the k-mers at the first (up to) kBatch set bits of bits,
// positions base + bit, and clears those bits; returns how many.  The
// loads are independent, so all of them are in flight together.
__device__ __forceinline__ int load_batch(const int64_t* __restrict__ row,
                                          int base, unsigned& bits,
                                          unsigned long long (&v)[kBatch]) {
  int nb = 0;
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      v[q] = static_cast<unsigned long long>(
          __ldg(reinterpret_cast<const long long*>(row) + base + b));
      nb = q + 1;
    }
  }
  return nb;
}

template <int E>
__device__ __forceinline__ void store_batch(
    unsigned long long* buf, int& off, int Wb, int nb,
    const unsigned long long (&v)[kBatch]) {
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    if (q < nb) {
      if (off < Wb) buf[taxor::reg_slot<E>(off)] = v[q];
      ++off;
    }
  }
}

template <int T, int E, bool kVec>
__global__ void __launch_bounds__(T) dedup_kernel(
    const int64_t* __restrict__ kmer, const uint8_t* __restrict__ emit,
    int L, int hcap, int Wb, int64_t* __restrict__ out_kmer,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ n_unique_out,
    int32_t* __restrict__ n_emit_out) {
  constexpr int kWarps = T / 32;
  constexpr int kSeg = T * 32 * kRunWords;  // positions a gather pass
  static_assert(kWarps <= 32 && E % 8 == 0, "dedup_kernel: T or E");
  extern __shared__ __align__(16) unsigned char smem[];
  int* warp_tot = reinterpret_cast<int*>(smem);
  int* n_unique = warp_tot + 32;
  unsigned long long* warp_last =
      reinterpret_cast<unsigned long long*>(smem + 256);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem + kHeader);
  const int r = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t* krow = kmer + (size_t)r * L;
  const uint8_t* erow = emit + (size_t)r * L;
  if (tid == 0) *n_unique = 0;

  // 1. gather the emitted k-mers in position order
  int n = 0;  // emissions before this pass: the same in every thread
  for (int s0 = 0; s0 < L; s0 += kSeg) {
    const int end = min(L, s0 + kSeg);
    const int run = ((end - s0 + T - 1) / T + 15) & ~15;  // <= 128
    const int p0 = s0 + tid * run;
    // every load of the run issued before the first is used
    uint4 ev[2 * kRunWords];
#pragma unroll
    for (int c = 0; c < 2 * kRunWords; ++c)  // 16 positions a load
      ev[c] = load_emit16<kVec>(erow + p0 + 16 * c,
                                16 * c < run ? end - p0 - 16 * c : 0);
    unsigned msk[kRunWords] = {};
#pragma unroll
    for (int c = 0; c < 2 * kRunWords; ++c)
      msk[c >> 1] |= (emit_bits(ev[c].x) | emit_bits(ev[c].y) << 4 |
                      emit_bits(ev[c].z) << 8 | emit_bits(ev[c].w) << 12)
                     << (16 * (c & 1));
    int cnt = 0;
#pragma unroll
    for (int c = 0; c < kRunWords; ++c) cnt += __popc(msk[c]);
    unsigned long long v[kBatch];
    unsigned rest = msk[0];
    int nb = load_batch(krow, p0, rest, v);  // in flight over the scan
    int x = cnt;  // inclusive warp scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    int off = n + x - cnt, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_tot[w];
      off += w < warp ? c : 0;
      tot += c;
    }
    store_batch<E>(buf, off, Wb, nb, v);
#pragma unroll
    for (int c = 0; c < kRunWords; ++c) {
      unsigned bits = c == 0 ? rest : msk[c];
      while (bits && off < Wb) {
        nb = load_batch(krow, p0 + 32 * c, bits, v);
        store_batch<E>(buf, off, Wb, nb, v);
      }
    }
    n += tot;
    __syncthreads();  // buf complete; warp_tot free for the next pass
  }

  // 2. sort the row's own keys: P = pow2(m), P/E threads
  const int m = min(n, Wb);
  const int Ta = max(1, taxor::pow2_at_least(m) / E);
  unsigned long long k[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = tid * E + j;
    k[j] = tid < Ta && i < m ? buf[taxor::reg_slot<E>(i)] : taxor::kSentinel;
  }
  taxor::reg_sort<E>(k, Ta, buf);

  // 3. first occurrences, counted over all emissions
  const unsigned long long up_lane =
      __shfl_up_sync(0xFFFFFFFFu, k[E - 1], 1);
  if (lane == 31) warp_last[warp] = k[E - 1];
  __syncthreads();
  const unsigned long long before =
      lane > 0 ? up_lane : (warp > 0 ? warp_last[warp - 1] : 0);
  unsigned flags = 0;
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int i = tid * E + j;
    const unsigned long long prev = j > 0 ? k[j - 1] : before;
    const bool ok = i < m && (i == 0 || k[j] != prev) &&
                    k[j] != taxor::kSentinel;
    flags |= (unsigned)ok << j;
    cnt += ok;
  }
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if (lane == 0 && cnt) atomicAdd(n_unique, cnt);  // one add a warp

  // 4. the hcap slots, from registers; the sentinel past P
  const size_t o = (size_t)r * hcap;
  if (tid < Ta) {
    if ((hcap & 7) == 0) {  // 16-byte aligned pairs, 8 flags a word
#pragma unroll
      for (int j = 0; j < E; j += 8) {
        const int i = tid * E + j;
        if (i < hcap) {
          unsigned long long fw = 0;
#pragma unroll
          for (int q = 0; q < 8; q += 2) {
            *reinterpret_cast<longlong2*>(out_kmer + o + i + q) =
                make_longlong2((long long)k[j + q], (long long)k[j + q + 1]);
          }
#pragma unroll
          for (int q = 0; q < 8; ++q)
            fw |= (unsigned long long)((flags >> (j + q)) & 1u) << (8 * q);
          *reinterpret_cast<unsigned long long*>(out_valid + o + i) = fw;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int i = tid * E + j;
        if (i < hcap) {
          out_kmer[o + i] = (int64_t)k[j];
          out_valid[o + i] = (flags >> j) & 1u;
        }
      }
    }
  }
  for (int i = Ta * E + tid; i < hcap; i += T) {
    out_kmer[o + i] = (int64_t)taxor::kSentinel;
    out_valid[o + i] = 0;
  }
  __syncthreads();
  if (tid == 0) {
    n_unique_out[r] = *n_unique;
    n_emit_out[r] = n > Wb ? kOverflow : n;
  }
}

template <int T, int E>
int launch_registers(const void* kmer, const void* emit, int R, int L,
                     int hcap, int Wb, void* out_kmer, void* out_valid,
                     void* n_unique, void* n_emit, cudaStream_t stream) {
  static_assert((T / 32) <= E, "one transpose covers the cross-warp bits");
  // the gather's buffer, in reg_sort's slots, is also the sort's
  const size_t smem = kHeader + 8 * ((size_t)Wb + Wb / E);
  const bool vec =
      (L & 15) == 0 && (reinterpret_cast<uintptr_t>(emit) & 15) == 0;
  const auto kernel =
      vec ? dedup_kernel<T, E, true> : dedup_kernel<T, E, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<R, T, smem, stream>>>(
      static_cast<const int64_t*>(kmer), static_cast<const uint8_t*>(emit),
      L, hcap, Wb, static_cast<int64_t*>(out_kmer),
      static_cast<uint8_t*>(out_valid), static_cast<int32_t*>(n_unique),
      static_cast<int32_t*>(n_emit));
  return (int)cudaGetLastError();
}

// --------------------------------------------------- global-scratch route
constexpr int kScratchThreads = 256;
constexpr int kScratchWarps = kScratchThreads / 32;
constexpr int kScratchHeader = 64;  // warp totals and the unique count

__global__ void __launch_bounds__(kScratchThreads) dedup_scratch_kernel(
    const int64_t* __restrict__ kmer, const uint8_t* __restrict__ emit,
    int L, int hcap, int Wb, unsigned long long* __restrict__ scratch,
    int64_t* __restrict__ out_kmer, uint8_t* __restrict__ out_valid,
    int32_t* __restrict__ n_unique_out, int32_t* __restrict__ n_emit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  int* warp_tot = reinterpret_cast<int*>(smem);
  int* n_unique = warp_tot + kScratchWarps;
  unsigned long long* buf = scratch + (size_t)r * Wb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)r * L;

  // 1. gather the emitted k-mers in position order
  int n = 0;  // emissions before this tile: the same in every thread
  for (int t0 = 0; t0 < L; t0 += kScratchThreads) {
    const int i = t0 + threadIdx.x;
    const bool e = i < L && emit[row + i];
    const unsigned ball = __ballot_sync(0xFFFFFFFFu, e);
    if (lane == 0) warp_tot[warp] = __popc(ball);
    __syncthreads();
    int off = n + __popc(ball & ((1u << lane) - 1u));
    for (int w = 0; w < kScratchWarps; ++w) {
      const int c = warp_tot[w];
      if (w < warp) off += c;
      n += c;
    }
    if (e && off < Wb) buf[off] = (unsigned long long)kmer[row + i];
    __syncthreads();  // warp_tot is rewritten by the next tile
  }

  // 2. pad to a power of two and sort
  const int m = min(n, Wb);
  const int P = taxor::pow2_at_least(m);
  for (int i = m + threadIdx.x; i < P; i += blockDim.x)
    buf[i] = taxor::kSentinel;
  if (threadIdx.x == 0) *n_unique = 0;
  __syncthreads();
  taxor::bitonic_sort(buf, P);

  // 3. first occurrences, counted over all emissions, then hcap slots
  int local = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    local += (j == 0 || buf[j] != buf[j - 1]) && buf[j] != taxor::kSentinel;
  atomicAdd(n_unique, local);  // integer sum: order-free
  for (int j = threadIdx.x; j < hcap; j += blockDim.x) {
    const size_t o = (size_t)r * hcap + j;
    const unsigned long long v = j < P ? buf[j] : taxor::kSentinel;
    out_kmer[o] = (int64_t)v;
    out_valid[o] = j < m && (j == 0 || v != buf[j - 1]) &&
                   v != taxor::kSentinel;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_unique_out[r] = *n_unique;
    n_emit_out[r] = n > Wb ? kOverflow : n;
  }
}

}  // namespace

// scratch: a [R, Wb] u64 row a read where Wb > 16,384, else null.
extern "C" int launch_dedup(const void* kmer, const void* emit, int R, int L,
                            int hcap, int Wb, void* scratch, void* out_kmer,
                            void* out_valid, void* n_unique, void* n_emit,
                            void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch) {
    dedup_scratch_kernel<<<R, kScratchThreads, kScratchHeader, s>>>(
        static_cast<const int64_t*>(kmer), static_cast<const uint8_t*>(emit),
        L, hcap, Wb, static_cast<unsigned long long*>(scratch),
        static_cast<int64_t*>(out_kmer), static_cast<uint8_t*>(out_valid),
        static_cast<int32_t*>(n_unique), static_cast<int32_t*>(n_emit));
    return (int)cudaGetLastError();
  }
  // E keys a thread, so that T*E covers Wb and one transpose the warps
  if (Wb <= 2048)
    return launch_registers<256, 8>(kmer, emit, R, L, hcap, Wb, out_kmer,
                                    out_valid, n_unique, n_emit, s);
  if (Wb <= 4096)
    return launch_registers<256, 16>(kmer, emit, R, L, hcap, Wb, out_kmer,
                                     out_valid, n_unique, n_emit, s);
  if (Wb <= 8192)
    return launch_registers<256, 32>(kmer, emit, R, L, hcap, Wb, out_kmer,
                                     out_valid, n_unique, n_emit, s);
  if (Wb <= 16384)
    return launch_registers<512, 32>(kmer, emit, R, L, hcap, Wb, out_kmer,
                                     out_valid, n_unique, n_emit, s);
  return (int)cudaErrorInvalidValue;  // needs the scratch route
}
