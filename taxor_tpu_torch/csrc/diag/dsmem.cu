// DSMEM rate: random 16-byte row reads from the shared memory of the other
// blocks of a thread-block cluster (distributed shared memory) against
// reads of the block's own, the measurement that picked the layout of
// K2's slab route for tall tables (thin slabs, csrc/probe_slab.cu, over
// the split variant of csrc/probe_cluster.cu).  Replaces no TPU kernel: a
// TPU core has no neighbour whose fast memory it reads.
//
// A launch runs `clusters` clusters of C blocks (C a power of two up to
// 16; past 8 a non-portable size), each block of kThreads threads holding
// 2^rows_log2 rows of 16 bytes, word i of rank q's rows fill_word(q, i).
// After a cluster barrier every thread reads `iters` rows, picked by its
// xorshift32 stream, and XORs them into four words, out[block, thread];
// a second barrier keeps each block's rows alive until the cluster is
// done.  Modes:
//   0 local   random rows of the block's own (ld.shared);
//   1 remote  random rows of rank (rank + 1) % C (ld.shared::cluster);
//   2 spread  random rows of all C x 2^rows_log2 rows of the cluster, the
//             rank of row g g >> rows_log2: a table split over a cluster
//             by rows, 1/C of the reads local;
//   3 word    random 4-byte words of the block's own, the access of a
//             block that holds 4 bins of every slot;
//   4 stream  rank (rank + 1) % C's rows in lane order, 512 contiguous
//             bytes a warp: a coalesced copy between blocks.
// Bound by the shared-memory or SM-to-SM network rate of the mode: the
// point of the kernel.  The xorshift and the XOR add 8 integer operations
// a read.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;

enum Mode { kLocal = 0, kRemote = 1, kSpread = 2, kWord = 3, kStream = 4 };

__device__ __forceinline__ uint32_t xs32(uint32_t x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x;
}

__device__ __forceinline__ uint32_t fill_word(uint32_t rank, uint32_t i) {
  return ((rank + 1u) * 0x9E3779B1u) ^ (i * 0x85EBCA77u);
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

template <int M>
__global__ void __launch_bounds__(kThreads)
    dsmem_rows_kernel(int rows_log2, int iters, uint4* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t buf[];
  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t C = cluster.num_blocks(), rank = cluster.block_rank();
  const uint32_t rows = 1u << rows_log2;
  for (uint32_t i = threadIdx.x; i < 4 * rows; i += kThreads)
    buf[i] = fill_word(rank, i);
  cluster.sync();  // every block's rows are written before any is read
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(buf);
  const uint32_t next = map_rank(base, (rank + 1) & (C - 1));
  const uint32_t gid = blockIdx.x * kThreads + threadIdx.x;
  uint32_t s = (gid * 0x9E3779B9u) | 1u;
  uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll 8
  for (int it = 0; it < iters; ++it) {
    s = xs32(s);
    uint4 v;
    if (M == kLocal) {
      v = *reinterpret_cast<const uint4*>(buf + 4 * (s & (rows - 1)));
    } else if (M == kRemote) {
      v = ld_cluster16(next + 16 * (s & (rows - 1)));
    } else if (M == kSpread) {
      const uint32_t g = s & (C * rows - 1);
      v = ld_cluster16(map_rank(base + 16 * (g & (rows - 1)), g >> rows_log2));
    } else if (M == kWord) {
      v = make_uint4(buf[s & (4 * rows - 1)], 0, 0, 0);
    } else {
      v = ld_cluster16(next +
                       16 * (((uint32_t)it * kThreads + threadIdx.x) &
                             (rows - 1)));
    }
    acc.x ^= v.x;
    acc.y ^= v.y;
    acc.z ^= v.z;
    acc.w ^= v.w;
  }
  cluster.sync();  // no block leaves while another may read its rows
  out[gid] = acc;
}

template <int M>
cudaError_t configure(int C, int rows_log2, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute* attr) {
  const auto kern = dsmem_rows_kernel<M>;
  const int smem = 16 << rows_log2;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <int M>
int run(int C, int clusters, int rows_log2, int iters, void* out,
        void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<M>(C, rows_log2, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  if (clusters == 0) {  // none: the most that are resident at once
    cfg.gridDim = dim3((unsigned)C);  // a whole cluster, as the query needs
    err = cudaOccupancyMaxActiveClusters(&clusters, dsmem_rows_kernel<M>,
                                         &cfg);
    return err == cudaSuccess ? -clusters : (int)err;
  }
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, dsmem_rows_kernel<M>, rows_log2, iters,
                           static_cast<uint4*>(out));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0-4 (above); C a power of two, 1-16; rows_log2 such that the rows
// fit a block (16 << rows_log2 bytes); out: uint32 [clusters * C, kThreads,
// 4].  clusters 0 launches nothing and returns minus the clusters that
// are resident at once (cudaOccupancyMaxActiveClusters); else
// cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int launch_dsmem_rows(int mode, int C, int clusters,
                                 int rows_log2, int iters, void* out,
                                 void* stream) {
  if (C < 1 || C > 16 || (C & (C - 1)) || clusters < 0 || rows_log2 < 0 ||
      rows_log2 > 13 || iters < 0 || (clusters > 0 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kLocal: return run<kLocal>(C, clusters, rows_log2, iters, out, stream);
    case kRemote: return run<kRemote>(C, clusters, rows_log2, iters, out, stream);
    case kSpread: return run<kSpread>(C, clusters, rows_log2, iters, out, stream);
    case kWord: return run<kWord>(C, clusters, rows_log2, iters, out, stream);
    case kStream: return run<kStream>(C, clusters, rows_log2, iters, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
