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
// 8-byte records in slot order, p0 | p1 << 16 and p2 | fprint << 16
// (u16 positions: the route needs S * 16 bytes of shared memory, so
// S < 65536), and counts them; the G tables of a call share one seed and
// block length, so one launch serves all of them, and the slab blocks of
// every bin slab read the same records.  probe_slab_kernel<CH> then runs
// one block per (slab, read group, g): b = 16 CH bins, a row of the slab
// is CH chunks of 16 bytes.  A warp takes one read at a time (no block
// barrier after the copy); lane = hash-lane x CH + chunk, so 32 / CH
// hash-lanes take every (32 / CH)-th record, and each lane reads its chunk
// of the three rows as three 16-byte shared loads, XORs them with the
// fingerprint's 4 copies and adds the zero bytes (zero_bytes) into four
// packed byte counters, one a word.  The counters flush into 16
// int32 counts every kFlush records, before a byte can reach 256, as the
// TPU kernels' _FLUSH_BODIES did; at the end of a read warp shuffles sum
// the hash-lanes and hash-lane 0 writes the chunk's 16 counts.  Exact
// above 256, deterministic (no atomics), invalid slots never counted, an
// inactive (g, r) writes zeros and reads no record.  The last slab of a
// table whose width is not a multiple of b is ragged: its lanes past the
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
// widest slab that fits one block (probe_slab_bins; the narrower ones
// measured slower).  The records' stream, 8 bytes a valid hash for every
// slab, and the one copy of the table come from L2/HBM beside it.  A block
// has 32 warps, so a slab that fills the SM's shared memory still keeps 32
// reads in flight; __vseteq4 compiles to as many instructions as
// zero_bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_stage.cuh"

namespace {

constexpr int kRecThreads = 256;
constexpr int kSlabThreads = 1024;  // 32 warps, each on its own read
constexpr int kSlabWarps = kSlabThreads / 32;
constexpr int kFlush = 255;  // records a lane counts between flushes

// Records of the valid slots of read blockIdx.x, compacted in slot order
// with warp ballots; nrec[r] = their count.
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
          make_uint2(p0 | (p1 << 16), p2 | (fp << 16));
    }
    n += total;
    __syncthreads();  // warp_n is rewritten next round
  }
  if (threadIdx.x == 0) nrec[blockIdx.x] = n;
}

using taxor::cp_async16;
using taxor::flush_bytes;
using taxor::zero_bytes;

template <int CH>
__global__ void __launch_bounds__(kSlabThreads) probe_slab_kernel(
    const uint2* __restrict__ rec, const int* __restrict__ nrec, int R,
    int H, const uint8_t* __restrict__ table, size_t table_bytes, int S,
    int Bpad, const uint8_t* __restrict__ active, int reads_per_block,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t slab[];  // S rows of kRow bytes
  constexpr int HL = 32 / CH;                       // hash-lanes of a warp
  constexpr int kRow = 16 * CH;                     // the slab's bins
  const int g = blockIdx.z;
  const int s0 = blockIdx.x * 16 * CH;        // the slab's first bin
  const int nch = min(CH, (Bpad - s0) >> 4);  // its chunks (ragged last)
  {
    const uint8_t* src = table + (size_t)g * table_bytes + s0;
    const int c = threadIdx.x % CH;
    if (c < nch)
      for (int row = threadIdx.x / CH; row < S; row += kSlabThreads / CH)
        cp_async16(slab + row * kRow + c * 16,
                   src + (size_t)row * Bpad + c * 16);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CH, hl = lane / CH;
  const uint8_t* mine = slab + c * 16;
  const int r1 = min(R, (int)(blockIdx.y + 1) * reads_per_block);
  for (int r = blockIdx.y * reads_per_block + warp; r < r1;
       r += kSlabWarps) {
    const size_t gr = (size_t)g * R + r;
    int4* dst = reinterpret_cast<int4*>(out + gr * Bpad + s0 + c * 16);
    int cnt[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cnt[j] = 0;
    if (active == nullptr || active[gr]) {  // uniform over the warp
      const int n = c < nch ? nrec[r] : 0;
      const uint2* rr = rec + (size_t)r * H;
      for (int e0 = hl; e0 < n; e0 += kFlush * HL) {
        const int e1 = min(n, e0 + kFlush * HL);
        uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
#pragma unroll 4
        for (int e = e0; e < e1; e += HL) {
          const uint2 q = __ldg(rr + e);
          const uint4 a = *reinterpret_cast<const uint4*>(
              mine + (q.x & 0xFFFFu) * kRow);
          const uint4 b = *reinterpret_cast<const uint4*>(
              mine + (q.x >> 16) * kRow);
          const uint4 d = *reinterpret_cast<const uint4*>(
              mine + (q.y & 0xFFFFu) * kRow);
          const uint32_t f4 = (q.y >> 16) * 0x01010101u;
          k0 += zero_bytes(a.x ^ b.x ^ d.x ^ f4);
          k1 += zero_bytes(a.y ^ b.y ^ d.y ^ f4);
          k2 += zero_bytes(a.z ^ b.z ^ d.z ^ f4);
          k3 += zero_bytes(a.w ^ b.w ^ d.w ^ f4);
        }
        flush_bytes(cnt, k0);
        flush_bytes(cnt + 4, k1);
        flush_bytes(cnt + 8, k2);
        flush_bytes(cnt + 12, k3);
      }
#pragma unroll
      for (int off = CH; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          cnt[j] += __shfl_xor_sync(0xFFFFFFFFu, cnt[j], off);
    }
    if (hl == 0 && c < nch) {
      dst[0] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
      dst[1] = make_int4(cnt[4], cnt[5], cnt[6], cnt[7]);
      dst[2] = make_int4(cnt[8], cnt[9], cnt[10], cnt[11]);
      dst[3] = make_int4(cnt[12], cnt[13], cnt[14], cnt[15]);
    }
  }
}

template <int CH>
cudaError_t launch_slab(const uint2* rec, const int* nrec, int R, int H,
                        const uint8_t* table, int G, int S, int Bpad,
                        const uint8_t* active, int32_t* out,
                        cudaStream_t stream) {
  const auto kern = probe_slab_kernel<CH>;
  const int smem = S * 16 * CH;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, occ = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        kSlabThreads, smem);
  if (err != cudaSuccess) return err;
  // read groups: as many as fill one wave of blocks, none with fewer reads
  // than warps
  const int slabs = (Bpad + 16 * CH - 1) / (16 * CH);
  long groups = (long)sms * (occ > 0 ? occ : 1) / ((long)slabs * G);
  groups = groups < 1 ? 1 : groups;
  const long most = (R + kSlabWarps - 1) / kSlabWarps;
  groups = groups > most ? most : groups;
  const int per = (int)((R + groups - 1) / groups);
  const dim3 grid(slabs, (R + per - 1) / per, G);
  kern<<<grid, kSlabThreads, smem, stream>>>(
      rec, nrec, R, H, table, (size_t)S * Bpad, S, Bpad, active, per, out);
  return cudaGetLastError();
}

}  // namespace

// The slab width in bins of the slab route for G tables [S, Bpad] on CUDA
// device `device`: the widest of 128, 64, 32, 16 bins (no wider than
// Bpad needs) whose [S, b] slab fits one block's shared memory; 0 where
// none fits (the rows route, probe.cu), -1 on a CUDA error.
extern "C" int probe_slab_bins(int S, int Bpad, int device) {
  if (S <= 0 || S >= 65536 || Bpad <= 0 || Bpad % 16) return 0;
  int smem = 0;
  if (cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  int b = 128;
  while (b > 16 && b / 2 >= Bpad) b /= 2;
  for (; b >= 16; b /= 2)
    if ((long)S * b <= smem) return b;
  return 0;
}

// The slab route (called by launch_probe_count, probe.cu): slab_bins of 16,
// 32, 64 or 128, as probe_slab_bins picks it; rec uint64 [R, H] and nrec
// int32 [R] scratch.
extern "C" int launch_probe_slab(const void* hi, const void* lo,
                                 const void* valid, int R, int H,
                                 const void* table, int G, int S, int Bpad,
                                 const void* active, uint64_t seed,
                                 uint32_t block_length, int slab_bins,
                                 void* rec, void* nrec, void* out,
                                 void* stream) {
  if ((slab_bins != 16 && slab_bins != 32 && slab_bins != 64 &&
       slab_bins != 128) ||
      S <= 0 || S >= 65536 || Bpad % 16 ||
      reinterpret_cast<uintptr_t>(table) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  probe_records_kernel<<<R, kRecThreads, 0, st>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), H, seed, block_length,
      static_cast<uint2*>(rec), static_cast<int*>(nrec));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const auto* r = static_cast<const uint2*>(rec);
  const auto* n = static_cast<const int*>(nrec);
  const auto* t = static_cast<const uint8_t*>(table);
  const auto* a = static_cast<const uint8_t*>(active);
  auto* o = static_cast<int32_t*>(out);
  switch (slab_bins) {
    case 16:
      return (int)launch_slab<1>(r, n, R, H, t, G, S, Bpad, a, o, st);
    case 32:
      return (int)launch_slab<2>(r, n, R, H, t, G, S, Bpad, a, o, st);
    case 64:
      return (int)launch_slab<4>(r, n, R, H, t, G, S, Bpad, a, o, st);
    default:
      return (int)launch_slab<8>(r, n, R, H, t, G, S, Bpad, a, o, st);
  }
}
