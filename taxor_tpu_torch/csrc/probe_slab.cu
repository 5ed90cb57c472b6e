// K2's slab route: the probe/count of probe.cu with the fingerprint table
// held in shared memory one slab of bins at a time.
//
// counts[g, r, b] = active[g, r] * #{ valid h in read r :
//                   T_g[p0(h), b] ^ T_g[p1(h), b] ^ T_g[p2(h), b] == fprint(h) }
//
// Replaces, with probe.cu, the five live TPU probe kernels of
// taxor_tpu/device/pallas_probe.py (_kernel_p10x2, _kernel_p16,
// _kernel_wide_p16, _kernel, _kernel_wide).  Their grid was (bin tiles,
// reads) with the reads minor, so a bin tile of the table, fetched into
// VMEM once (choose_bin_tile4, up to 14 MiB), served the whole read batch.
// The slab is the Hopper form of that bin tile: a block owns (table g, a
// slab of b bins, a group of reads), copies the [S, b] slab into dynamic
// shared memory once with cp.async, and streams its reads' hashes through
// it.  The rows route (probe.cu) reads three table rows from L2 for every
// valid hash and bin block instead, and reuses nothing on chip.
//
// Two launches.  probe_records_kernel turns each read's valid slots into
// 8-byte records in slot order, p0 | (p1 - bl) << 16 and (p2 - 2 bl) |
// fprint << 16: each position relative to its segment (the three probe
// positions of a hash lie in three segments of bl slots), u16 for any bl
// < 65536, so S < 196,608; and counts them.  The G tables of a call share
// one seed and block length, so one launch serves all of them, and the
// slab blocks of every bin slab read the same records.
// probe_slab_kernel<ROW> then runs one block per (slab, read group, g): a
// slab of b = ROW bins, a row of it ROW bytes.  A lane reads a chunk of CW
// = min(ROW, 16) bytes of a row; a warp takes one read at a time (no
// block barrier after the copy); lane = hash-lane x CH + chunk, so 32 /
// CH hash-lanes take every (32 / CH)-th record, and each lane reads its
// chunk of the three rows as three shared loads, XORs them with the
// fingerprint's 4 copies and adds the zero bytes (zero_bytes) into packed
// byte counters, one a word of 4 bins.  The counters flush into int32
// counts every kFlush records, before a byte can reach 256, as the TPU
// kernels' _FLUSH_BODIES did; at the end of a read warp shuffles sum the
// hash-lanes and hash-lane 0 writes the chunk's counts.  Exact above 256,
// deterministic (no atomics), invalid slots never counted, an inactive
// (g, r) writes zeros and reads no record.  The last slab of a table
// whose width is not a multiple of b is ragged: its lanes past the
// table's width only join the shuffles.
//
// What bounds it on the H100: shared-memory row reads.  Each valid hash
// reads 3 rows x b bytes from each slab, 3 x Bpad bytes in all, at 128
// bytes a clock an SM when conflict-free.  The rows are random, so the
// chunks of one quarter-warp (128 bytes) collide in a bank unless their
// rows sit in distinct bank groups: at b = 128 a quarter-warp reads one
// row and never conflicts, at b = 64 two rows collide with probability
// 1/2 (1.5 wavefronts a quarter on average), at b = 32 four rows, at b =
// 16 eight.  A padded row stride cannot help random rows (a row needs b/4
// banks wherever it starts; on the H100 a 16-byte pad made every width
// slower), so slab rows are b bytes, unpadded, and the launcher takes the
// widest slab that fits one block (probe_slab_fit; the narrower ones
// measured slower).  The records' stream, 8 bytes a valid hash for every
// slab, and the one copy of the table come from L2/HBM beside it.  A block
// has 32 warps, so a slab that fills the SM's shared memory still keeps 32
// reads in flight; __vseteq4 compiles to as many instructions as
// zero_bytes.
//
// Thin slabs.  A 16-bin slab fits one block up to ~14,500 slots; a taller
// table takes slabs of 8, 4, 2 or 1 bins, each holding its bins of every
// slot (13b's [39,621, 1,024] table: 256 slabs of 4 bins, 158 KB each), so
// that every row read stays in shared memory and each byte of the table
// is fetched once a read group.  A thin slab pays its records' stream, 8
// bytes a valid hash, once for each of Bpad / b slabs, and a read's first
// loads and reduction once a block: it gains on the rows route (probe.cu,
// three rows from L2 a hash and 512-bin block) only where reads carry many
// hashes.  probe_slab_bins takes thin slabs of 8 or 4 bins for reads of
// at least kThinMinSlots hash slots (the plain k-mer and minimiser
// schemes' H = L = 8,192 bucket); the card measured them slower than the
// rows route at 1,024 slots (500 valid) and at 2 and 1 bins
// (tools/bench_probe.py, tools/bench_gather_scale.py --shapes thin).
// Holding the slab across a thread-block cluster instead, a 16-bin slab
// split by segment with two of each hash's rows read from other blocks
// (distributed shared memory), is the variant of probe_cluster.cu:
// random 16-byte rows of another block's shared memory ran at ~1.1-1.3
// TB/s for the card against ~11-13 TB/s from the block's own
// (tools/bench_dsmem.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_stage.cuh"

namespace {

constexpr int kRecThreads = 256;
constexpr int kSlabThreads = 1024;  // 32 warps, each on its own read
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kFlush = 255;  // records a lane counts between flushes
constexpr int kMaxSlots = 196608;  // u16 positions within a segment
constexpr int kThinMinBins = 4;    // probe_slab_bins' thinnest slab
constexpr int kThinMinSlots = 8192;  // and its fewest hash slots a read

// Records of the valid slots of read blockIdx.x, compacted in slot order
// with warp ballots, each position relative to its segment; nrec[r] =
// their count.
__global__ void __launch_bounds__(kRecThreads) probe_records_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, int H, uint64_t seed, uint32_t bl,
    uint2* __restrict__ rec, int* __restrict__ nrec) {
  __shared__ int warp_n[kRecThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = (size_t)blockIdx.x * H;
  int n = 0;
  for (int h = 0; h < H; h += kRecThreads) {
    const int j = h + threadIdx.x;
    const bool v = j < H && valid[row0 + j];
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, v);
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int off = n, total = 0;
    for (int q = 0; q < kRecThreads / 32; ++q) {
      off += q < warp ? warp_n[q] : 0;
      total += warp_n[q];
    }
    if (v) {
      const uint64_t key = ((uint64_t)(uint32_t)hi[row0 + j] << 32) |
                           (uint32_t)lo[row0 + j];
      uint32_t p0, p1, p2, fp;
      taxor::probe_slots(key, seed, bl, p0, p1, p2, fp);
      rec[row0 + off + __popc(ballot & ((1u << lane) - 1))] =
          make_uint2(p0 | ((p1 - bl) << 16), (p2 - 2 * bl) | (fp << 16));
    }
    n += total;
    __syncthreads();  // warp_n is rewritten next round
  }
  if (threadIdx.x == 0) nrec[blockIdx.x] = n;
}

using taxor::cp_async16;
using taxor::flush_bytes;
using taxor::zero_bytes;

// One CW-byte chunk of a table row into the slab: a cp.async of 16, 8 or
// 4 bytes, byte copies below that; the caller commits and waits.
template <int CW>
__device__ __forceinline__ void copy_chunk(uint8_t* smem,
                                           const uint8_t* gmem) {
  if constexpr (CW == 16) {
    cp_async16(smem, gmem);
  } else if constexpr (CW >= 4) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(CW));
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j) smem[j] = gmem[j];
  }
}

// The zero bytes of the CW-byte chunks at `mine` of rows p0, p1 and p2 of
// ROW bytes, XORed with the fingerprint's copies f4, added into packed
// byte counters k[0 .. (CW + 3) / 4), a word for 4 bins (below 4 bytes
// the bytes past CW are set, so they never count).
template <int CW, int ROW>
__device__ __forceinline__ void count_rows(const uint8_t* mine, uint32_t p0,
                                           uint32_t p1, uint32_t p2,
                                           uint32_t f4, uint32_t* k) {
  if constexpr (CW == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(mine + p0 * ROW);
    const uint4 b = *reinterpret_cast<const uint4*>(mine + p1 * ROW);
    const uint4 d = *reinterpret_cast<const uint4*>(mine + p2 * ROW);
    k[0] += zero_bytes(a.x ^ b.x ^ d.x ^ f4);
    k[1] += zero_bytes(a.y ^ b.y ^ d.y ^ f4);
    k[2] += zero_bytes(a.z ^ b.z ^ d.z ^ f4);
    k[3] += zero_bytes(a.w ^ b.w ^ d.w ^ f4);
  } else if constexpr (CW == 8) {
    const uint2 a = *reinterpret_cast<const uint2*>(mine + p0 * 8);
    const uint2 b = *reinterpret_cast<const uint2*>(mine + p1 * 8);
    const uint2 d = *reinterpret_cast<const uint2*>(mine + p2 * 8);
    k[0] += zero_bytes(a.x ^ b.x ^ d.x ^ f4);
    k[1] += zero_bytes(a.y ^ b.y ^ d.y ^ f4);
  } else if constexpr (CW == 4) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(mine);
    k[0] += zero_bytes(s[p0] ^ s[p1] ^ s[p2] ^ f4);
  } else if constexpr (CW == 2) {
    const uint16_t* s = reinterpret_cast<const uint16_t*>(mine);
    k[0] += zero_bytes(((uint32_t)(s[p0] ^ s[p1] ^ s[p2]) ^ f4) |
                       0xFFFF0000u);
  } else {
    k[0] += zero_bytes(((uint32_t)(mine[p0] ^ mine[p1] ^ mine[p2]) ^ f4) |
                       0xFFFFFF00u);
  }
}

// One block an SM at most (a slab fills shared memory), so the compiler
// may take 64 registers a thread: capped at 32, the thin slabs' record
// loop kept too few loads in flight (13b's shape on the H100: 1.39 ms
// unrolled 4 deep, 2.09 unrolled 8, against 1.30 with 57 registers).
template <int ROW>
__global__ void __launch_bounds__(kSlabThreads, 1) probe_slab_kernel(
    const uint2* __restrict__ rec, const int* __restrict__ nrec, int R,
    int H, const uint8_t* __restrict__ table, size_t table_bytes, int S,
    int Bpad, uint32_t bl, const uint8_t* __restrict__ active,
    int reads_per_block, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t slab[];  // S rows of ROW bytes
  constexpr int CW = ROW < 16 ? ROW : 16;  // bytes (bins) a lane reads
  constexpr int CH = ROW / CW;             // chunks of a row
  constexpr int HL = 32 / CH;              // hash-lanes of a warp
  constexpr int NK = (CW + 3) / 4;         // packed counter words
  const int g = blockIdx.z;
  const int s0 = blockIdx.x * ROW;               // the slab's first bin
  const int nch = min(CH, (Bpad - s0) / CW);     // its chunks (ragged last)
  {
    const uint8_t* src = table + (size_t)g * table_bytes + s0;
    const int c = threadIdx.x % CH;
    if (c < nch)
      for (int row = threadIdx.x / CH; row < S; row += kSlabThreads / CH)
        copy_chunk<CW>(slab + row * ROW + c * CW,
                       src + (size_t)row * Bpad + c * CW);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CH, hl = lane / CH;
  const uint8_t* mine = slab + c * CW;
  const int r0 = blockIdx.y * reads_per_block + warp;
  const int r1 = min(R, (int)(blockIdx.y + 1) * reads_per_block);
  // the next read's record count is loaded while the warp counts the
  // current one
  int n_next = r0 < r1 ? __ldg(nrec + r0) : 0;
  for (int r = r0; r < r1; r += kSlabWarps) {
    const size_t gr = (size_t)g * R + r;
    const int n_read = n_next;
    n_next = r + kSlabWarps < r1 ? __ldg(nrec + r + kSlabWarps) : 0;
    int cnt[4 * NK];
#pragma unroll
    for (int j = 0; j < 4 * NK; ++j) cnt[j] = 0;
    if (active == nullptr || active[gr]) {  // uniform over the warp
      const int n = c < nch ? n_read : 0;
      const uint2* rr = rec + (size_t)r * H;
      for (int e0 = hl; e0 < n; e0 += kFlush * HL) {
        const int e1 = min(n, e0 + kFlush * HL);
        uint32_t k[NK] = {};
        // records come from L2 for every slab: twice as many in flight
        // on the thin slabs, many slabs a table
#pragma unroll (ROW < 16 ? 8 : 4)
        for (int e = e0; e < e1; e += HL) {
          const uint2 q = __ldg(rr + e);
          count_rows<CW, ROW>(mine, q.x & 0xFFFFu, (q.x >> 16) + bl,
                              (q.y & 0xFFFFu) + 2 * bl,
                              (q.y >> 16) * 0x01010101u, k);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) flush_bytes(cnt + 4 * j, k[j]);
      }
      if constexpr (CH == 1) {
#pragma unroll
        for (int j = 0; j < CW; ++j)
          cnt[j] = __reduce_add_sync(0xFFFFFFFFu, cnt[j]);
      } else {
#pragma unroll
        for (int off = CH; off < 32; off <<= 1)
#pragma unroll
          for (int j = 0; j < CW; ++j)
            cnt[j] += __shfl_xor_sync(0xFFFFFFFFu, cnt[j], off);
      }
    }
    if (hl == 0 && c < nch) {
      int32_t* dst = out + gr * Bpad + s0 + c * CW;
      if constexpr (CW >= 4) {
#pragma unroll
        for (int j = 0; j < CW / 4; ++j)
          reinterpret_cast<int4*>(dst)[j] = make_int4(
              cnt[4 * j], cnt[4 * j + 1], cnt[4 * j + 2], cnt[4 * j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < CW; ++j) dst[j] = cnt[j];
      }
    }
  }
}

template <int ROW>
cudaError_t launch_slab(const uint2* rec, const int* nrec, int R, int H,
                        const uint8_t* table, int G, int S, int Bpad,
                        uint32_t bl, const uint8_t* active, int32_t* out,
                        cudaStream_t stream) {
  const auto kern = probe_slab_kernel<ROW>;
  const int smem = S * ROW;
  // read groups: as many as fill one wave of blocks, none with fewer reads
  // than warps
  const int slabs = (Bpad + ROW - 1) / ROW;
  int per = 0;
  const cudaError_t err = taxor::slab_read_groups(
      kern, kSlabThreads, smem, (long)slabs * G, R, kSlabWarps, per);
  if (err != cudaSuccess) return err;
  const dim3 grid(slabs, (R + per - 1) / per, G);
  kern<<<grid, kSlabThreads, smem, stream>>>(rec, nrec, R, H, table,
                                             (size_t)S * Bpad, S, Bpad, bl,
                                             active, per, out);
  return cudaGetLastError();
}

}  // namespace

// The widest slab of the slab route that fits G tables [S, Bpad] on CUDA
// device `device`, in bins: the widest of 128, 64, 32, 16 (no wider than
// Bpad needs), 8, 4, 2 and 1 whose [S, b] slab fits one block's shared
// memory; 0 from kMaxSlots slots or where none fits, -1 on a CUDA error.
// The probe diagnostics take its 16- to 128-bin part for any B a
// multiple of 4 (device/diag.py, slab_bins): a change there is made to
// both.
extern "C" int probe_slab_fit(int S, int Bpad, int device) {
  if (S <= 0 || S >= kMaxSlots || Bpad <= 0 || Bpad % 16) return 0;
  int smem = 0;
  if (cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int b = 128;
  while (b > 16 && b / 2 >= Bpad) b /= 2;
  for (; b >= 1; b /= 2)
    if ((long)S * b <= smem) return b;
  return 0;
}

// K2's rule (device/probe.py k2_counts) for tables [S, Bpad] and reads of
// H hash slots: the slab route with probe_slab_fit's slab where it has 16
// bins or more, or kThinMinBins or more and H is at least kThinMinSlots
// (the thin slabs above); else 0, the rows route (probe.cu); -1 on a
// CUDA error.
extern "C" int probe_slab_bins(int S, int Bpad, int H, int device) {
  const int b = probe_slab_fit(S, Bpad, device);
  if (b < 0) return -1;
  return b >= 16 || (b >= kThinMinBins && H >= kThinMinSlots) ? b : 0;
}

// The records pass of the slab route and of probe_cluster.cu's split
// variant: rec uint64 [R, H] and nrec int32 [R] (above).
extern "C" int launch_probe_records(const void* hi, const void* lo,
                                    const void* valid, int R, int H,
                                    uint64_t seed, uint32_t block_length,
                                    void* rec, void* nrec, void* stream) {
  probe_records_kernel<<<R, kRecThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), H, seed, block_length,
      static_cast<uint2*>(rec), static_cast<int*>(nrec));
  return (int)cudaGetLastError();
}

// The slab route (called by launch_probe_count, probe.cu): slab_bins a
// power of two from 1 to 128, as probe_slab_bins or probe_slab_fit picks
// it; rec uint64 [R, H] and nrec int32 [R] scratch.
extern "C" int launch_probe_slab(const void* hi, const void* lo,
                                 const void* valid, int R, int H,
                                 const void* table, int G, int S, int Bpad,
                                 const void* active, uint64_t seed,
                                 uint32_t block_length, int slab_bins,
                                 void* rec, void* nrec, void* out,
                                 void* stream) {
  if (slab_bins < 1 || slab_bins > 128 || (slab_bins & (slab_bins - 1)) ||
      S <= 0 || S >= kMaxSlots || block_length == 0 ||
      3L * block_length > S || Bpad % 16 ||
      reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = (cudaError_t)launch_probe_records(
      hi, lo, valid, R, H, seed, block_length, rec, nrec, stream);
  if (err != cudaSuccess) return (int)err;
  const auto* r = static_cast<const uint2*>(rec);
  const auto* n = static_cast<const int*>(nrec);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* a = static_cast<const uint8_t*>(active);
  auto* o = static_cast<int32_t*>(out);
  const uint32_t bl = block_length;
  switch (slab_bins) {
#define TAXOR_SLAB_CASE(b) \
  case b:                  \
    return (int)launch_slab<b>(r, n, R, H, t, G, S, Bpad, bl, a, o, st);
    TAXOR_SLAB_CASE(1)
    TAXOR_SLAB_CASE(2)
    TAXOR_SLAB_CASE(4)
    TAXOR_SLAB_CASE(8)
    TAXOR_SLAB_CASE(16)
    TAXOR_SLAB_CASE(32)
    TAXOR_SLAB_CASE(64)
    default:
      return (int)launch_slab<128>(r, n, R, H, t, G, S, Bpad, bl, a, o, st);
#undef TAXOR_SLAB_CASE
  }
}
