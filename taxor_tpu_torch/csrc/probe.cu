// K2: interleaved XOR filter probe/count over a stack of G tables.
//
// counts[g, r, b] = active[g, r] * #{ valid h in read r :
//                   T_g[p0(h), b] ^ T_g[p1(h), b] ^ T_g[p2(h), b] == fprint(h) }
//
// Replaces the five live TPU probe kernels of
// taxor_tpu/device/pallas_probe.py, which compute this one function and
// differ only in how the TPU's SMEM/VMEM were fed: _kernel_p10x2
// (_probe_call_p10x2 via _probe_call_chunked_p10), _kernel_p16
// (_probe_call_p16), _kernel_wide_p16 (_probe_call_wide_p16), _kernel
// (_probe_call) and _kernel_wide (_probe_call_wide).  The group axis
// replaces the lax.scan over the stacked subgroups of one descent level
// (taxor_tpu/device/e2e.py make_hixf_e2e_grouped_fn), and the activity
// mask the zero trip counts of inactive reads (pallas_probe._body_counts):
// a read inactive in table g writes zeros and stages no hash.  Tables of
// at most 512 bins take K2n instead (probe_narrow.cu).
//
// Two routes, chosen by shape alone (probe_slab_bins in probe_slab.cu):
// where a slab of the table fits one block's shared memory, 16 bins or
// more of it, or a thin slab of 8 or 4 bins of every slot for reads of
// 8,192 hash slots or more, the slab route (probe_slab.cu) holds the table
// on chip one bin slab at a time, the Hopper form of the TPU kernels' VMEM
// bin tile; elsewhere this file's rows route reads the rows from L2 or
// HBM.
//
// The rows route computes each hash's probe slots and fingerprint itself
// (probe_stage.cuh).  Invalid slots are dropped when a tile is staged, so
// there is no sentinel row, no poison fingerprint and no packed positions.
//
// Grid: x = read, y = 512-bin column block, z = table g.  Each thread owns
// 4 adjacent bins (one 32-bit word of every table row) and is the only
// writer of their 4 counts: no atomics, deterministic output.  Per tile of
// up to kTile hashes the block stages the probes of the valid slots into
// shared memory; then every thread XORs 3 table words per hash and counts
// zero bytes.
//
// What bounds the rows route on the H100: fingerprint-row bytes, 3 rows x
// Bpad bytes per valid hash, from L2 (a flat table of a few tens of MB
// stays in the 50 MB L2) or HBM, with no reuse on chip.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_stage.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, 512 bins per block
constexpr int kTile = 1024;    // hashes staged per round

__global__ void __launch_bounds__(kThreads) probe_count_kernel(
    const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
    const uint8_t* __restrict__ valid, int R, int H,
    const uint32_t* __restrict__ table, size_t table_words, int B4,
    const uint8_t* __restrict__ active, uint64_t seed, uint32_t bl,
    int32_t* __restrict__ out) {
  __shared__ int p0[kTile], p1[kTile], p2[kTile];
  __shared__ uint32_t f4[kTile];
  __shared__ int warp_n[kThreads / 32];
  const int r = blockIdx.x;
  const size_t gr = (size_t)blockIdx.z * R + r;
  const int col = blockIdx.y * kThreads + threadIdx.x;
  int4* dst = reinterpret_cast<int4*>(out + gr * B4 * 4);
  if (active != nullptr && !active[gr]) {  // uniform over the block
    if (col < B4) dst[col] = make_int4(0, 0, 0, 0);
    return;
  }
  table += blockIdx.z * table_words;
  const size_t row0 = (size_t)r * H;
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  int h = 0;  // next slot of the read to stage
  while (h < H) {
    const int n = taxor::stage_probes<kThreads, kTile>(
        hi, lo, valid, row0, H, h, seed, bl, p0, p1, p2, f4, warp_n);
    if (col < B4) {
#pragma unroll 4
      for (int e = 0; e < n; ++e) {
        const uint32_t x = table[(size_t)p0[e] * B4 + col] ^
                           table[(size_t)p1[e] * B4 + col] ^
                           table[(size_t)p2[e] * B4 + col] ^ f4[e];
        c0 += (x & 0xFFu) == 0;
        c1 += (x & 0xFF00u) == 0;
        c2 += (x & 0xFF0000u) == 0;
        c3 += (x & 0xFF000000u) == 0;
      }
    }
    __syncthreads();  // the tile is restaged next round
  }
  if (col < B4) dst[col] = make_int4(c0, c1, c2, c3);
}

}  // namespace

extern "C" int launch_probe_slab(const void* hi, const void* lo,
                                 const void* valid, int R, int H,
                                 const void* table, int G, int S, int Bpad,
                                 const void* active, uint64_t seed,
                                 uint32_t block_length, int slab_bins,
                                 void* rec, void* nrec, void* out,
                                 void* stream);

// tables: G contiguous uint8 [S, Bpad] tables; active: uint8 [G, R] or
// null (every read active); out: int32 [G, R, Bpad].  slab_bins 0 takes
// the rows route, else the slab route with slabs of slab_bins bins
// (probe_slab_bins or probe_slab_fit) and the scratch rec (uint64 [R, H])
// and nrec (int32 [R]).
extern "C" int launch_probe_count(const void* hi, const void* lo,
                                  const void* valid, int R, int H,
                                  const void* table, int G, int S, int Bpad,
                                  const void* active, uint64_t seed,
                                  uint32_t block_length, int slab_bins,
                                  void* rec, void* nrec, void* out,
                                  void* stream) {
  if (R == 0 || G == 0) return 0;
  if (slab_bins != 0)
    return launch_probe_slab(hi, lo, valid, R, H, table, G, S, Bpad, active,
                             seed, block_length, slab_bins, rec, nrec, out,
                             stream);
  const int B4 = Bpad / 4;
  const dim3 grid(R, (B4 + kThreads - 1) / kThreads, G);
  probe_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(lo),
      static_cast<const uint8_t*>(valid), R, H,
      static_cast<const uint32_t*>(table), (size_t)S * B4, B4,
      static_cast<const uint8_t*>(active), seed, block_length,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
