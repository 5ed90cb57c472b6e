// K5: minimiser and plain k-mer extraction with the FracMinHash keep, one
// thread block cluster per span of up to 32,768 end positions of a read,
// one block per tile of the span, four consecutive end positions a thread.
//
// Replaces the XLA graph taxor_tpu/hash/device_syncmer.minimizer_kmers (no
// Pallas kernel): its rolling words (_rolling_packed_words), the van
// Herk/Gil-Werman sliding leftmost minimum over (hi, lo) u32 pairs
// (_sliding_leftmost_min_pair) and the emission masks, some 60-100 tensor
// operations over [R, L] a batch; and the FracMinHash keep that followed
// it in the fused step (taxor_tpu/device/e2e._scaling_keep, 35 int64
// tensor operations over every slot in the port before this kernel took
// it).  The reference's non-syncmer scheme is seqan3's minimiser_hash
// (src/main/taxor_search.cpp:210-212): the value of the k-mer ending at
// base i is v(i) = min(fwd ^ seed, rc ^ seed) as a uint64, seed =
// adjust_seed(k) (hash/minimizer.py); the holder of a window of w' =
// window - k + 1 values is always its LEFTMOST minimum, and a position
// emits when the holder changes:
//
//   emit[i] = i < len and (i == k + w' - 2
//             or (i > k + w' - 2 and argmin(i) != argmin(i - 1)))
//
// writing the window's minimum.  No argmin is tracked here.  With S(i) the
// minimum of the w' - 1 values v(i - w' + 1 .. i - 1) that the windows
// ending at i - 1 and at i share, the holder of window i - 1 is its oldest
// value v(i - w') iff v(i - w') <= S(i) (leftmost wins ties), and then it
// slides out; else the holder sits inside the shared part and is replaced
// only by a strictly smaller newcomer.  So
//
//   emit[i] = v(i - w') <= S(i) or v(i) < S(i),   value min(S(i), v(i)),
//
// for i > k + w' - 2; the values before k - 1 are stored as 0, which makes
// the first full window (i = k + w' - 2) emit by the same rule.  w' = 1
// (window == k) emits every position from k - 1 on, the plain canonical
// k-mers: a template instance of its own, with no window pass.  Duplicates
// are kept (vector semantics).  The keep: valid = emit and (thresh == 0 or
// wyhash64(value) <= thresh), T = schemes.scaling_threshold_u64, computed
// on the value in registers; n_emit counts emissions, n_unique the valid
// slots.
//
// A position's emission and value are a pure function of v(i - w'), S(i)
// and v(i), so no block needs another's results and a read of any length
// (a multiple of 16) is cut into spans of kSpan = 32,768 end positions,
// each one cluster; positions, k - 1 and the first full window k + w' - 2
// stay counted from the read's start.  Per cluster (read r, span c) of
// `tiles` blocks, block `rank` owning end positions [t0, t1), t0 = c *
// kSpan + rank * tile, thread j positions p0 = t0 + 4j .. p0 + 3:
//   1. the values of its four positions from four 2-bit words read from
//      global memory (L1 serves the neighbours' overlapping words): three
//      funnel shifts align the words at the first k-mer's first base, the
//      2-bit reversal of tracker.cuh is taken once on the aligned words,
//      and each position's forward and reverse-complement halves are funnel
//      shifts by a constant; w' > 1 stores them in shared memory, one pad
//      slot every four values, so that the window pass's strided loads hit
//      distinct banks, and the block's first threads compute the w' values
//      before the tile the same way (no block waits for another's values,
//      in its span or the one before);
//      block barrier;
//   2. (w' > 1) S(p0 + e) for e = 0..3 with one split at p0: a running
//      minimum over the w' - 1 values left of p0, from the right, whose
//      last four steps give the four suffix minima, and the prefix minima
//      of the thread's own values in registers (w' - 1 < 3 takes the
//      w' - 1 values directly);
//   3. hi and lo of the four positions as one 16-byte store each, valid as
//      one 4-byte store of four bytes;
//   4. the counts: a warp sum, written by each warp's lane 0 into the
//      cluster's first block through distributed shared memory (after the
//      wait on a cluster barrier arrived at on entry: every block has
//      started); after a second cluster barrier that block's first warp
//      sums them.  A read of one span (L <= kSpan) writes n_emit and
//      n_unique there: no output needs zeroing and nothing but K5
//      launches.  A longer read's spans each add their sums with one
//      global atomic a count, into n_emit and n_unique that the launcher
//      zeroes first (cudaMemsetAsync on the same stream).
// A tile, or a thread's four positions, at or past the read's length
// writes zeros and computes nothing.
//
// What bounds it on the H100.  The outputs, 9 bytes a position (hi, lo,
// valid), against a quarter byte a position in: bytes.  The work a position
// is ~16 integer operations for the value, (w' + 8) / 4 64-bit minima
// for the window and its value (w' + 8 in a thread's run of four), ~8 for
// the emission test, and for each emission one 64 x 64 bit multiply for
// the keep: ~39 32-bit operations a position at w' = 7 and ~11 an
// emission, under the bytes' time at the H100's integer rate but not far
// under it, so the design spends few operations twice (each value computed
// once but the w' before each tile, no argmin kept, no shared-memory pass
// at w' = 1).  A row's length does not change that: a span past the first
// recomputes only its first tile's halo.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tracker.cuh"
#include "u64.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRun = 4;          // end positions a thread owns
constexpr int kMaxTiles = 8;     // blocks of a span's cluster (portable)
constexpr int kMaxThreads = 1024;
constexpr int kSpan = kMaxTiles * kRun * kMaxThreads;  // 32,768
constexpr int kSlots = kMaxTiles * (kMaxThreads / 32);  // warp counts
constexpr unsigned long long kInf = ~0ull;

struct Geometry {
  int tiles, tile, threads;
};

// A span of L positions in `tiles` tiles of `tile` positions (a multiple
// of 4; the last one may be short), a thread per four positions.  A span
// of kSpan positions is kMaxTiles tiles of exactly kSpan / kMaxTiles.
__host__ __device__ inline Geometry geometry(int L) {
  Geometry g;
  g.tiles = (L + 1023) / 1024;
  if (g.tiles > kMaxTiles) g.tiles = kMaxTiles;
  g.tile = ((L + g.tiles - 1) / g.tiles + kRun - 1) / kRun * kRun;
  g.threads = (g.tile / kRun + 31) / 32 * 32;
  return g;
}

// Shared-memory slot of the value at tile-relative position q: one pad
// slot every four values, so that 32 threads loading the values at p0 - d
// (a stride of four positions) hit distinct banks.
__host__ __device__ inline int vslot(int q) { return q + (q >> 2); }

// Positions before the tile that the window pass reads (w' of them, the
// values of w' - 1 windows and the oldest value of the first), in runs.
__host__ __device__ inline int halo_len(int wp) {
  return wp > 1 ? (wp + kRun - 1) / kRun * kRun : 0;
}

__host__ inline size_t smem_bytes(int tile, int wp) {
  return kSlots * 2 * sizeof(int) +
         (size_t)vslot(halo_len(wp) + tile) * sizeof(unsigned long long) *
             (wp > 1);
}

__device__ __forceinline__ int floor_div16(int x) {
  return x >= 0 ? x / 16 : -((15 - x) / 16);
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

// Canonical XOR-seeded values of the k-mers ending at p0 .. p0 + 3; bases
// outside [0, L) read as A (their positions never reach an emitted
// window).
__device__ __forceinline__ void run_values(const uint32_t* __restrict__ src,
                                           int nwords, int p0, int k,
                                           uint64_t kmask, uint64_t seed,
                                           unsigned long long (&v)[kRun]) {
  const int b0 = p0 - k + 1;  // the first base of the first k-mer
  const int a = floor_div16(b0);
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g = a + j;
    w[j] = g >= 0 && g < nwords ? __ldg(src + g) : 0u;
  }
  // x: bases b0 .. b0 + 47, the oldest lowest; y: the same 2-bit reversed
  const int sh = 2 * (b0 - 16 * a);
  const uint32_t x0 = __funnelshift_r(w[0], w[1], sh);
  const uint32_t x1 = __funnelshift_r(w[1], w[2], sh);
  const uint32_t x2 = __funnelshift_r(w[2], w[3], sh);
  const uint32_t y0 = taxor::rev2_32(x0), y1 = taxor::rev2_32(x1),
                 y2 = taxor::rev2_32(x2);
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    // bases b0 + e .. b0 + e + 31: lo, hi; their reversal: rlo, rhi
    const uint32_t lo = __funnelshift_r(x0, x1, 2 * e);
    const uint32_t hi = __funnelshift_r(x1, x2, 2 * e);
    const uint32_t rlo = __funnelshift_l(y1, y0, 2 * e);
    const uint32_t rhi = __funnelshift_l(y2, y1, 2 * e);
    const uint64_t rc = (~(((uint64_t)hi << 32) | lo) & kmask) ^ seed;
    const uint64_t fwd =
        ((((uint64_t)rlo << 32) | rhi) >> (64 - 2 * k)) ^ seed;
    v[e] = fwd < rc ? fwd : rc;
  }
}

// The value at position j of the window pass, from shared memory, which
// holds positions [h0, end) of the block.
struct Values {
  const unsigned long long* sv;
  int h0;
  __device__ __forceinline__ unsigned long long operator()(int j) const {
    return sv[vslot(j - h0)];
  }
};

// Values at positions before k - 1 (no k-mer yet, or before the read)
// become 0, which makes the first full window emit by the rule above.
__device__ __forceinline__ void zero_before_kmers(
    int p0, int k, unsigned long long (&v)[kRun]) {
  if (p0 < k - 1) {
#pragma unroll
    for (int e = 0; e < kRun; ++e)
      if (p0 + e < k - 1) v[e] = 0;
  }
}

// S(p0 + e) (the minimum of the W = w' - 1 values before p0 + e) and
// old(p0 + e) = v(p0 + e - W - 1), for W >= kRun - 1: the W values left of
// p0 from the right, the last four steps giving the suffix minima, then
// the own values' prefix minima.
template <class Val>
__device__ __forceinline__ void window_split(
    const Val& val, int p0, int W, const unsigned long long (&v)[kRun],
    unsigned long long (&S)[kRun], unsigned long long (&old)[kRun]) {
  unsigned long long run = kInf;
  for (int j = p0 - 1; j > p0 - W + 3; --j) run = umin64(run, val(j));
  if (W >= kRun) run = umin64(run, val(p0 - W + 3));
  S[3] = run;  // kInf when W == 3: the window of p0 + 3 is v0..v2
  old[3] = val(p0 - W + 2);
  run = umin64(run, old[3]);
  S[2] = run;
  old[2] = val(p0 - W + 1);
  run = umin64(run, old[2]);
  S[1] = run;
  old[1] = val(p0 - W);
  S[0] = umin64(run, old[1]);
  old[0] = val(p0 - W - 1);
  const unsigned long long p1 = v[0], p2 = umin64(p1, v[1]),
                           p3 = umin64(p2, v[2]);
  S[1] = umin64(S[1], p1);
  S[2] = umin64(S[2], p2);
  S[3] = umin64(S[3], p3);
}

// The same for W = 1 and 2, from the values directly.
template <class Val>
__device__ __forceinline__ void window_direct(
    const Val& val, int p0, int W, unsigned long long (&S)[kRun],
    unsigned long long (&old)[kRun]) {
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const int i = p0 + e;
    S[e] = W == 1 ? val(i - 1) : umin64(val(i - 1), val(i - 2));
    old[e] = val(i - W - 1);
  }
}

// Writes the run's outputs and adds its emissions and valid slots.
__device__ __forceinline__ void store_run(
    size_t at, const unsigned long long (&m)[kRun], const bool (&emit)[kRun],
    uint64_t thresh, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_valid,
    int& c_emit, int& c_keep) {
  int h[kRun], l[kRun];
  uint32_t valid = 0;
#pragma unroll
  for (int e = 0; e < kRun; ++e) {
    const unsigned long long x = emit[e] ? m[e] : 0ull;
    h[e] = (int32_t)(uint32_t)(x >> 32);
    l[e] = (int32_t)(uint32_t)x;
    const bool keep =
        emit[e] && (thresh == 0 || taxor::wyhash64(x) <= thresh);
    valid |= (uint32_t)keep << (8 * e);
    c_emit += emit[e];
    c_keep += keep;
  }
  *reinterpret_cast<int4*>(out_hi + at) = make_int4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<int4*>(out_lo + at) = make_int4(l[0], l[1], l[2], l[3]);
  *reinterpret_cast<uint32_t*>(out_valid + at) = valid;
}

template <bool kWindow>  // false: w' = 1, no window pass
__global__ void __launch_bounds__(kMaxThreads) minimizer_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int spans, int k, int wp, uint64_t seed, uint64_t thresh,
    int tile, int32_t* __restrict__ out_hi, int32_t* __restrict__ out_lo,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ n_emit,
    int32_t* __restrict__ n_unique) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* slots = reinterpret_cast<int*>(smem);  // [kSlots][2], rank 0's
  unsigned long long* sv =
      reinterpret_cast<unsigned long long*>(smem + kSlots * 2 * sizeof(int));
  cg::cluster_group cluster = cg::this_cluster();
  const int tiles = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int c = (int)(blockIdx.x / tiles);  // (read, span) of the cluster
  const int r = c / spans;
  const int t0 = (c % spans) * kSpan + rank * tile;
  const int t1 = min(t0 + tile, L);
  const int len = max(0, min(lengths[r], L));
  const int end = min(t1, len);  // positions that may emit: [t0, end)
  const int p0 = t0 + kRun * (int)threadIdx.x;
  const size_t at = (size_t)r * L + p0;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(packed) +
                        (size_t)r * (L / 16);
  const uint64_t kmask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
  const int first = k + wp - 2;  // the first full window's end
  int c_emit = 0, c_keep = 0;
  bool emit[kRun];
  unsigned long long v[kRun];
  // every block has started before the counts go to rank 0
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (p0 < end) run_values(src, L / 16, p0, k, kmask, seed, v);
  if (kWindow) {
    // the tile's values and the halo's before it, recomputed here: no
    // block waits for another's
    const int h0 = t0 - halo_len(wp);
    if (p0 < end) {
      zero_before_kmers(p0, k, v);
#pragma unroll
      for (int e = 0; e < kRun; ++e) sv[vslot(p0 - h0 + e)] = v[e];
    }
    if (t0 < end) {
      for (int q = threadIdx.x; q < (t0 - h0) / kRun; q += blockDim.x) {
        const int hp = h0 + kRun * q;
        unsigned long long hv[kRun];
        run_values(src, L / 16, hp, k, kmask, seed, hv);
        zero_before_kmers(hp, k, hv);
#pragma unroll
        for (int e = 0; e < kRun; ++e) sv[vslot(hp - h0 + e)] = hv[e];
      }
    }
    __syncthreads();
    if (p0 < end) {
      const int W = wp - 1;
      unsigned long long S[kRun], old[kRun];
      if (W >= kRun - 1)
        window_split(Values{sv, h0}, p0, W, v, S, old);
      else
        window_direct(Values{sv, h0}, p0, W, S, old);
#pragma unroll
      for (int e = 0; e < kRun; ++e) {
        const int i = p0 + e;
        emit[e] = i >= first && i < end && (old[e] <= S[e] || v[e] < S[e]);
        v[e] = umin64(S[e], v[e]);
      }
    }
  } else if (p0 < end) {
#pragma unroll
    for (int e = 0; e < kRun; ++e) emit[e] = p0 + e >= first && p0 + e < end;
  }
  if (p0 < t1) {
    if (p0 < end) {
      store_run(at, v, emit, thresh, out_hi, out_lo, out_valid, c_emit,
                c_keep);
    } else {  // past the read
      *reinterpret_cast<int4*>(out_hi + at) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(out_lo + at) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<uint32_t*>(out_valid + at) = 0u;
    }
  }

  // the span's counts: warp sums into rank 0's slots, summed there
  c_emit = __reduce_add_sync(0xFFFFFFFFu, c_emit);
  c_keep = __reduce_add_sync(0xFFFFFFFFu, c_keep);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int warps = blockDim.x / 32;
  if ((threadIdx.x & 31) == 0) {
    int* dst = cluster.map_shared_rank(slots, 0u) +
               2 * (rank * warps + (int)(threadIdx.x >> 5));
    dst[0] = c_emit;
    dst[1] = c_keep;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 32) {
    int se = 0, sk = 0;
    for (int j = threadIdx.x; j < tiles * warps; j += 32) {
      se += slots[2 * j];
      sk += slots[2 * j + 1];
    }
    se = __reduce_add_sync(0xFFFFFFFFu, se);
    sk = __reduce_add_sync(0xFFFFFFFFu, sk);
    if (threadIdx.x == 0) {
      if (spans == 1) {
        n_emit[r] = se;
        n_unique[r] = sk;
      } else {  // zeroed by the wrapper
        atomicAdd(n_emit + r, se);
        atomicAdd(n_unique + r, sk);
      }
    }
  }
}

}  // namespace

// thresh 0: no FracMinHash keep (valid = emit).  Writes every output; for
// rows longer than kSpan it zeroes n_emit and n_unique, into which the
// spans add their counts.
extern "C" int launch_minimizer(const void* packed, const void* lengths,
                                int R, int L, int k, int wp,
                                unsigned long long seed,
                                unsigned long long thresh, void* out_hi,
                                void* out_lo, void* out_valid, void* n_emit,
                                void* n_unique, void* stream) {
  if (R == 0 || L == 0) return 0;
  if (L % 16 || k < 2 || k > 32 || wp < 1) return (int)cudaErrorInvalidValue;
  const int spans = (L + kSpan - 1) / kSpan;
  if ((long long)R * spans * kMaxTiles > 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  const Geometry g = geometry(spans == 1 ? L : kSpan);
  const bool window = wp > 1;
  const size_t smem = smem_bytes(g.tile, wp);
  if (smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        (const void*)minimizer_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (a != cudaSuccess) return (int)a;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)R * spans * g.tiles);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.tiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const int32_t* ln = static_cast<const int32_t*>(lengths);
  int32_t* hi = static_cast<int32_t*>(out_hi);
  int32_t* lo = static_cast<int32_t*>(out_lo);
  uint8_t* va = static_cast<uint8_t*>(out_valid);
  int32_t* ne = static_cast<int32_t*>(n_emit);
  int32_t* nu = static_cast<int32_t*>(n_unique);
  if (spans > 1) {
    const size_t bytes = (size_t)R * sizeof(int32_t);
    cudaError_t z = cudaMemsetAsync(ne, 0, bytes, cfg.stream);
    if (z == cudaSuccess) z = cudaMemsetAsync(nu, 0, bytes, cfg.stream);
    if (z != cudaSuccess) return (int)z;
  }
  cudaError_t e =
      window ? cudaLaunchKernelEx(&cfg, minimizer_kernel<true>, pk, ln, L,
                                  spans, k, wp, (uint64_t)seed,
                                  (uint64_t)thresh, g.tile, hi, lo, va, ne,
                                  nu)
             : cudaLaunchKernelEx(&cfg, minimizer_kernel<false>, pk, ln, L,
                                  spans, k, wp, (uint64_t)seed,
                                  (uint64_t)thresh, g.tile, hi, lo, va, ne,
                                  nu);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
