// A variant of K2's slab route (probe_slab.cu), timed beside it and
// never the shape's pick: the 16-bin slab of a table too tall for one
// block held across a thread-block cluster, two of each hash's three rows
// read from other blocks' shared memory (distributed shared memory).
//
// counts[g, r, b] = active[g, r] * #{ valid h in read r :
//                   T_g[p0(h), b] ^ T_g[p1(h), b] ^ T_g[p2(h), b] == fprint(h) }
//
// The TPU kernels (taxor_tpu/device/pallas_probe.py) held one VMEM bin
// tile of up to 14 MiB (_FP_VMEM_SINGLE, choose_bin_tile4) for the whole
// read batch.  A block's 227 KB hold a 16-bin slab of at most ~14,500
// slots; a cluster of up to 16 blocks holds 3.6 MB.  The three probe
// positions of a hash lie in three segments of bl slots, so the [S, 16]
// slab splits over C = 3m blocks, block k holding part k % m of segment
// k / m (13b's [39,621, 1,024] table fits clusters of 3 blocks of 211
// KB).  It reads the slab route's records (probe_slab.cu's records pass,
// positions relative to their segment).  A warp takes a read, a lane a
// record, and reads each of its three 16-byte rows from the block that
// holds it (mapa + ld.shared::cluster), at least two of them from another
// block: bound by those remote rows, 2/3 of 3 x Bpad bytes a hash.  On the
// H100 (tools/bench_dsmem.py over csrc/diag/dsmem.cu) random 16-byte
// reads of another block's shared memory ran at ~1.1-1.3 TB/s for the
// card against ~11-13 TB/s from the block's own, so the slab route holds
// thin slabs of every slot in each block instead, all its row reads local
// (probe_slab.cu); this variant stays as the measure of that choice.
//
// Exact past 256 (packed byte counters flushed before a byte can reach
// 256), deterministic (integer sums in a fixed order, no atomics),
// invalid slots never counted (the records pass drops them), an inactive
// (g, r) writes zeros and reads no record.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "probe_stage.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // 32 warps
constexpr int kWarps = kThreads / 32;
constexpr int kFlush = 255;  // records a lane counts between flushes

using taxor::cp_async16;
using taxor::flush_bytes;
using taxor::zero_bytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of shared address `addr` in block `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint4 ld_cluster16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The [S, 16] slab over C = 3m blocks.
__global__ void __launch_bounds__(kThreads, 1) probe_split_kernel(
    const uint2* __restrict__ rec, const int* __restrict__ nrec, int R,
    int H, const uint8_t* __restrict__ table, size_t table_bytes, int Bpad,
    uint32_t bl, int m, uint32_t part, uint64_t magic,
    const uint8_t* __restrict__ active, int reads_per_cluster,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t slab[];  // part rows of 16 bytes
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int g = blockIdx.z;
  const int s0 = blockIdx.x / C * 16;  // the slab's first bin
  {
    const int seg = rank / m, j = rank % m;
    const int first = j * (int)part;
    const int rows = min((int)part, (int)bl - first);
    const uint8_t* src =
        table + (size_t)g * table_bytes + (size_t)(seg * bl + first) * Bpad + s0;
    for (int row = threadIdx.x; row < rows; row += kThreads)
      cp_async16(slab + row * 16, src + (size_t)row * Bpad);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
  }
  cluster_arrive();  // every block's rows are in before any is read
  cluster_wait();
  const uint32_t base = smem_u32(slab);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * reads_per_cluster;
  const int r1 = min(R, r0 + reads_per_cluster);
  for (int r = r0 + rank * kWarps + warp; r < r1; r += C * kWarps) {
    const size_t gr = (size_t)g * R + r;
    int cnt[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) cnt[j] = 0;
    if (active == nullptr || active[gr]) {  // uniform over the warp
      const int n = nrec[r];
      const uint2* rr = rec + (size_t)r * H;
      for (int e0 = lane; e0 < n; e0 += kFlush * 32) {
        const int e1 = min(n, e0 + kFlush * 32);
        uint32_t k0 = 0, k1 = 0, k2 = 0, k3 = 0;
        for (int e = e0; e < e1; e += 32) {
          const uint2 x = __ldg(rr + e);
          const uint32_t rel[3] = {x.x & 0xFFFFu, x.x >> 16, x.y & 0xFFFFu};
          uint4 v[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const uint32_t jj = (uint32_t)((rel[i] * magic) >> 32);
            v[i] = ld_cluster16(map_rank(base + (rel[i] - jj * part) * 16,
                                         (uint32_t)(i * m) + jj));
          }
          const uint32_t f4 = (x.y >> 16) * 0x01010101u;
          k0 += zero_bytes(v[0].x ^ v[1].x ^ v[2].x ^ f4);
          k1 += zero_bytes(v[0].y ^ v[1].y ^ v[2].y ^ f4);
          k2 += zero_bytes(v[0].z ^ v[1].z ^ v[2].z ^ f4);
          k3 += zero_bytes(v[0].w ^ v[1].w ^ v[2].w ^ f4);
        }
        flush_bytes(cnt, k0);
        flush_bytes(cnt + 4, k1);
        flush_bytes(cnt + 8, k2);
        flush_bytes(cnt + 12, k3);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        cnt[j] = __reduce_add_sync(0xFFFFFFFFu, cnt[j]);
    }
    if (lane == 0) {
      int4* dst = reinterpret_cast<int4*>(out + gr * Bpad + s0);
      dst[0] = make_int4(cnt[0], cnt[1], cnt[2], cnt[3]);
      dst[1] = make_int4(cnt[4], cnt[5], cnt[6], cnt[7]);
      dst[2] = make_int4(cnt[8], cnt[9], cnt[10], cnt[11]);
      dst[3] = make_int4(cnt[12], cnt[13], cnt[14], cnt[15]);
    }
  }
  cluster_arrive();  // no block leaves while another may read its rows
  cluster_wait();
}

int smem_optin(int device) {
  int smem = 0;
  if (cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return smem;
}

cudaLaunchConfig_t cluster_config(int C, int smem, cudaLaunchAttribute* a,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = C;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  return cfg;
}

// Sets the kernel's shared memory (and a non-portable cluster size past
// 8) and returns in `n` the clusters of C blocks the card holds at once.
template <typename Kernel>
cudaError_t max_clusters(Kernel kern, int C, int smem, int& n) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute a[1];
  cudaLaunchConfig_t cfg = cluster_config(C, smem, a, nullptr);
  cfg.gridDim = dim3((unsigned)C);
  err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  if (err == cudaSuccess && n < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

cudaError_t launch_split(const uint2* rec, const int* nrec, int R, int H,
                         const uint8_t* table, int G, int S, int Bpad,
                         uint32_t bl, const uint8_t* active, int C,
                         int32_t* out, cudaStream_t stream) {
  const int m = C / 3;
  const uint32_t part = (bl + m - 1) / m;
  const uint64_t magic = ((1ull << 32) + part - 1) / part;
  const int smem = (int)(16 * part);
  int n = 0;
  cudaError_t err = max_clusters(probe_split_kernel, C, smem, n);
  if (err != cudaSuccess) return err;
  // read groups: as many as fill one wave of clusters, none smaller than
  // a read a warp
  const int slabs = Bpad / 16;
  long groups = std::max(1L, (long)n / ((long)slabs * G));
  groups = std::min(groups, (long)(R + C * kWarps - 1) / (C * kWarps));
  const int per = (int)((R + groups - 1) / groups);
  cudaLaunchAttribute a[1];
  cudaLaunchConfig_t cfg = cluster_config(C, smem, a, stream);
  cfg.gridDim = dim3((unsigned)(slabs * C), (unsigned)((R + per - 1) / per),
                     (unsigned)G);
  err = cudaLaunchKernelEx(&cfg, probe_split_kernel, rec, nrec, R, H, table,
                           (size_t)S * Bpad, Bpad, bl, m, part, magic, active,
                           per, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int launch_probe_records(const void* hi, const void* lo,
                                    const void* valid, int R, int H,
                                    uint64_t seed, uint32_t block_length,
                                    void* rec, void* nrec, void* stream);

// The split variant's cluster for tables [S, Bpad] with block length bl:
// 3m blocks, m the fewest parts of a segment whose [ceil(bl / m), 16]
// rows fit one block, up to 15 blocks; 0 where none fits, -1 on a CUDA
// error.
extern "C" int probe_cluster_split(int S, int Bpad, int bl, int device) {
  if (S <= 0 || S >= 196608 || bl <= 0 || 3L * bl > S || Bpad % 16)
    return 0;
  const int smem = smem_optin(device);
  if (smem < 0) return -1;
  for (int m = 1; 3 * m <= 15; ++m)
    if (16L * ((bl + m - 1) / m) <= smem) return 3 * m;
  return 0;
}

// The split variant (device/probe.py k2_counts(variant="split")): the
// records pass, then clusters of C = 3m <= 15 blocks (probe_cluster_split)
// over each 16-bin slab; rec uint64 [R, H] and nrec int32 [R] scratch.
extern "C" int launch_probe_split(const void* hi, const void* lo,
                                  const void* valid, int R, int H,
                                  const void* table, int G, int S, int Bpad,
                                  const void* active, uint64_t seed,
                                  uint32_t block_length, int C, void* rec,
                                  void* nrec, void* out, void* stream) {
  if (R == 0 || G == 0) return 0;
  if (S <= 0 || S >= 196608 || block_length == 0 ||
      3L * block_length > S || Bpad % 16 ||
      reinterpret_cast<uintptr_t>(table) % 16 || C % 3 || C < 3 || C > 15)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = (cudaError_t)launch_probe_records(
      hi, lo, valid, R, H, seed, block_length, rec, nrec, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_split(
      static_cast<const uint2*>(rec), static_cast<const int*>(nrec), R, H,
      static_cast<const uint8_t*>(table), G, S, Bpad, block_length,
      static_cast<const uint8_t*>(active), C, static_cast<int32_t*>(out),
      (cudaStream_t)stream);
}
