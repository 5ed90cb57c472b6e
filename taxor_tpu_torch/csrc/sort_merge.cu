// K4's merge route (csrc/sort_pairs.cu routes to it): rows of more than
// kChunk = 16,384 (hi, lo) pairs, Wp keys a row padded with the all-ones
// sentinel to a power of two.  The register network of pairsort.cuh sorts
// each chunk of kChunk keys of the row (a block a chunk) and writes it as
// u64 keys into a scratch row; then log2(Wp / kChunk) merge-path passes
// (merge_pass_kernel) each merge pairs of sorted runs into runs twice as
// long, ping-ponging between two scratch rows, with many blocks a pair: a
// block owns kTile consecutive outputs, finds where its first and last
// output's diagonals cut the two runs (a binary search each, in global
// memory), stages the two slices (kTile keys in all) in shared memory with
// coalesced 8-byte loads, each thread merges kPer outputs after a binary
// search of its own diagonal in shared memory, and the block stores its
// tile coalesced through shared memory.  The last pass splits the keys into
// hi and lo and writes the row's first W.  Ties take the first run's key
// first, in the searches and the merge alike, so the cuts agree.
//
// Replaces, with sort_pairs.cu, taxor_tpu/device/pallas_sort.py:62
// _sort_kernel.  What bounds it on the H100: one read and one write of
// 8 bytes a pair, 0.0100 ms at [8, 262,144].  The route before it was one
// 1,024-thread block a row running the shared-memory network of
// bitonic.cuh over a global scratch row: 171 passes over the row at
// 262,144 keys, 8 blocks on 132 SMs, 6.08 ms there (PERF.md §6).  Here the
// chunks fill the card (R x Wp / 16,384 blocks of the register network),
// and each merge pass moves the row once each way, 16.8 MB a pass at [8,
// 262,144], which the 50 MB L2 holds with its ping-pong partner; a pass's
// blocks spend their start on two dependent binary searches (~17 loads).

#include "pairsort.cuh"

namespace {

// ------------------------------------------------------ merge-path route
constexpr int kChunk = 16384;  // keys a chunk sort takes (E = 32)
constexpr int kMergeThreads = 256;
constexpr int kPer = 8;  // outputs a thread merges
constexpr int kTile = kMergeThreads * kPer;  // outputs a block owns

// The keys of the first d outputs of merging sorted a[0, na) and b[0, nb)
// that come from a (ties: a's key first).
__device__ __forceinline__ int diagonal(const unsigned long long* a, int na,
                                        const unsigned long long* b, int nb,
                                        int d) {
  int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The shared-memory slot of output i of a tile: one spare key every kPer,
// so that a warp's lanes, kPer keys apart, write to distinct banks.
__device__ __forceinline__ int out_slot(int i) { return i + i / kPer; }

// One pass: src holds sorted runs of `run` keys (rows of Wp keys, pairs of
// runs side by side); block b merges outputs [tile * kTile, + kTile) of
// pair b / (2 run / kTile).  kLast: 2 run == Wp, the row's first W keys go
// to out_hi / out_lo (rows of W pairs); else to dst.
template <bool kLast>
__global__ void __launch_bounds__(kMergeThreads) merge_pass_kernel(
    const unsigned long long* __restrict__ src, int run, int W,
    unsigned long long* __restrict__ dst, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo) {
  __shared__ unsigned long long in[kTile];
  __shared__ unsigned long long out[kTile + kTile / kPer];
  __shared__ int cut[2];
  const int tiles = 2 * run / kTile;
  const size_t pair = blockIdx.x / tiles;
  const int d0 = (int)(blockIdx.x % tiles) * kTile;
  const unsigned long long* a = src + pair * 2 * run;
  const unsigned long long* b = a + run;
  const int t = threadIdx.x;
  if (t < 2) cut[t] = diagonal(a, run, b, run, d0 + t * kTile);
  __syncthreads();
  const int i0 = cut[0], na = cut[1] - i0;
  const int j0 = d0 - i0;  // nb = kTile - na
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int m = q * kMergeThreads + t;
    in[m] = m < na ? a[i0 + m] : b[j0 + m - na];
  }
  __syncthreads();
  const int nb = kTile - na;
  const unsigned long long* sa = in;
  const unsigned long long* sb = in + na;
  int i = diagonal(sa, na, sb, nb, t * kPer);
  int j = t * kPer - i;
  unsigned long long k[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const bool take_a = j >= nb || (i < na && sa[i] <= sb[j]);
    k[q] = take_a ? sa[i++] : sb[j++];
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) out[out_slot(t * kPer + q)] = k[q];
  __syncthreads();
  if constexpr (kLast) {
    const size_t row = pair * (size_t)W;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int m = q * kMergeThreads + t;
      if (d0 + m < W) {
        const unsigned long long x = out[out_slot(m)];
        out_hi[row + d0 + m] = (int32_t)(uint32_t)(x >> 32);
        out_lo[row + d0 + m] = (int32_t)(uint32_t)x;
      }
    }
  } else {
    unsigned long long* o = dst + pair * 2 * run + d0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int m = q * kMergeThreads + t;
      o[m] = out[out_slot(m)];
    }
  }
}

// Wp > kChunk: the chunks sorted into scratch, then the merge passes.
int launch_merge(const void* hi, const void* lo, int R, int W, int Wp,
                 unsigned long long* scratch, void* out_hi, void* out_lo,
                 cudaStream_t stream) {
  static_assert(kChunk % kTile == 0, "a chunk is whole tiles");
  const int chunks = Wp / kChunk;
  unsigned long long* buf[2] = {scratch, scratch + (size_t)R * Wp};
  int err = launch_registers<32, true>(hi, lo, R * chunks, W, kChunk, chunks,
                                       nullptr, nullptr, buf[0], stream);
  if (err) return err;
  int p = 0;
  for (int run = kChunk; 2 * run <= Wp; run *= 2, p ^= 1) {
    const long long blocks = (long long)R * Wp / kTile;
    if (2 * run == Wp)
      merge_pass_kernel<true><<<(unsigned)blocks, kMergeThreads, 0, stream>>>(
          buf[p], run, W, nullptr, static_cast<int32_t*>(out_hi),
          static_cast<int32_t*>(out_lo));
    else
      merge_pass_kernel<false><<<(unsigned)blocks, kMergeThreads, 0,
                                 stream>>>(buf[p], run, W, buf[p ^ 1],
                                           nullptr, nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}


}  // namespace

// Wp > kChunk (a power of two): scratch holds two [R, Wp] u64 rows a read.
extern "C" int launch_sort_merge(const void* hi, const void* lo, int R,
                                 int W, int Wp, void* scratch, void* out_hi,
                                 void* out_lo, void* stream) {
  if (R == 0 || W == 0) return 0;
  if (!scratch || Wp <= kChunk || Wp & (Wp - 1) || W > Wp)
    return (int)cudaErrorInvalidValue;
  return launch_merge(hi, lo, R, W, Wp,
                      static_cast<unsigned long long*>(scratch), out_hi,
                      out_lo, (cudaStream_t)stream);
}
