// K1: open canonical syncmer extraction, dedup and wyhash, one block per
// read; and syncmer_track, the first kernel of the split engine.
//
// K1 replaces the TPU kernel taxor_tpu/device/pallas_extract.py
// (_extract_kernel, launched by syncmer_hashes_fused) together with the
// bitonic network it inlines (taxor_tpu/device/pallas_sort.py
// _bitonic_body).  syncmer_track replaces the XLA scan
// taxor_tpu/hash/device_syncmer.syncmer_kmers (no Pallas kernel).  The TPU
// kernel computed a scan-free sliding argmin and sent reads with tied
// window minima to the host (n_emit = 2^30).  Here the tracker is
// position-parallel and exact (tracker.cuh: window_outcome,
// resolve_tied_runs): no flag, no fallback, n_emit is always the true
// count.
//
// Per block (read r, 256 threads):
//   1. stage the read's 2-bit words in shared memory, with zero words
//      before and after (tracker.cuh kBias);
//   2. every thread computes the canonical s-mers ys[i] of its positions:
//      one funnel shift of two staged words and a 2-bit reversal;
//   3. per window end i, a direct scan of ys[i-w+1 .. i] gives the minimum
//      and its leftmost and rightmost argmin: the window emits (unique
//      minimum at the offset), is tied, or is uncertain (tied, with a
//      minimum at the offset); __ballot_sync packs each outcome into one
//      32-bit word per 32 positions;
//   4. one thread per tied run holding an uncertain window replays the
//      tracker's rule over that run (resolve_tied_runs);
//   5. K1: a block-wide prefix sum over the emission words gathers the
//      emitted positions in order, each thread computes their canonical
//      k-mers (a 64-bit funnel shift of three staged words), then all
//      threads bitonic-sort the buffer (padded with all-ones to a power of
//      two), mark first occurrences, count them and wyhash the first hcap
//      slots.  syncmer_track instead writes, per position, the canonical
//      k-mer (int64 [R, L], bases before 0 read as A) and the emission bit
//      (bool [R, L], false past the length), coalesced.
// K1's outputs per read: hi/lo (int32 bit patterns of the wyhash) and
// valid for hcap slots in ascending canonical-k-mer order (0/0/false where
// a slot holds no first occurrence), n_unique over all emissions, n_emit.
//
// Reads longer than a block's shared memory holds (L_CAP = 32,768 bases:
// 148 KB of the 227 KB) run as pieces (P > 1): block b takes the Lp =
// L_CAP bases of read b / P from base (b % P) * stride, stride = L_CAP -
// 32, and writes row b of the outputs, as a whole read would.  A piece
// owns the windows from its first up to the next piece's first (row_of),
// so every window of the read is one piece's, and its emissions are the
// whole read's: a window whose minimum is unique does not depend on the
// past, and where the piece's first window is tied the piece starts from
// the read's holder there, which holder_at (tracker.cuh) replays from the
// last unique window before it in the read's packed row in global memory,
// however far back (a homopolymer or short tandem repeat across the cut).
// n_emit counts the owned emissions only; n_unique and the slots are the
// piece's own (device/sort.union_pieces joins the pieces of a read).
//
// What bounds them on the H100.  Per position, steps 2-3 take ~12 integer
// operations for the s-mer and ~4 per window element for the scan (w =
// k-s+1 = 11 for k=22/s=12: ~56 a position); syncmer_track adds ~14 for
// its k-mer and writes 9 bytes a position, so its bytes bound it.  K1
// reads a quarter byte a position and writes 9 bytes an hcap slot
// (hcap = L/4), which at the card's rates takes about as long as its
// operations (the scan, then the sort network over the emissions):
// chip_smoke.py's record says which of the two is larger.  Step 4 is
// serial only inside tied runs; a read tied everywhere is one run on one
// thread, as the whole read was before.
//
// Shared memory: one layout for both kernels (smem_layout), the whole read
// at once: a 64-byte header, the staged words (L/4 + 16 bytes), three bit
// masks (3 L/8 bytes) and ys.  K1's sort buffer of W = next power of two
// of the most emissions a read can have (hash/device_syncmer.max_emissions)
// reuses the ys region once step 4 is done, which grows it to 8 W bytes
// where that is larger (gap-1 schemes).  For s <= 15 (32-bit s-mers) ys
// is 4 L bytes: at L = 32768, 8,208 + 12,288 + 131,072 + 64 = 151,632
// bytes (148 KB) for both kernels at k=22/s=12 (W*8 = 64 KB fits the ys
// region), under the 227 KB a block may use; at L = 8192, 37,968 bytes.
// Where the sort buffer would not fit (gap-1 schemes at L = 32768: 256 KB)
// the wrapper passes a global scratch buffer; it asks the library
// (syncmer_extract_smem) which case holds.
//
// For 16 <= s <= 31 the canonical s-mer is a 64-bit word, and 8 L bytes
// of ys would not fit at L = 32768 (256 KB).  Steps 2-3 run in tiles
// (tile_len): ys holds the s-mers of one tile and the halo before it.  The
// 32-bit instance's tile is the whole row, with no halo; the 64-bit one's
// is kTile64 = 16,384 windows with a halo of 32 (a window reads w - 1 <=
// 30 s-mers back), (16,384 + 32) x 8 = 131,328 bytes, so the layout stays
// the 32-bit one's size at L = 32768 (151,888 bytes).  A row of one tile
// replays its tied runs (step 4) from ys; a row of two recomputes the
// s-mers it replays from the staged words, as holder_at does from global
// memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "bitonic.cuh"
#include "tracker.cuh"
#include "u64.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kHeader = 64;  // warp totals, the emission and unique counts

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Byte offsets of the shared-memory layout at length bucket L; sort_bytes
// is the size of a sort buffer kept in shared memory (0 for none).
struct Layout {
  size_t words, bits, region, total;
};

// Steps 2-3 run a tile of windows at a time, with ys holding the tile's
// s-mers and the halo before it that its first windows read (at least
// w - 1).  32-bit s-mers take the whole row as one tile, with no halo;
// 64-bit ones tiles of kTile64 windows.
constexpr int kTile64 = 16384;

template <class S>
__host__ __device__ constexpr int tile_len(int L) {
  return sizeof(S) == 4 || L < kTile64 ? L : kTile64;
}

template <class S>
__host__ __device__ constexpr int halo() {
  return sizeof(S) == 4 ? 0 : 32;
}

// Bytes of ys at row length L for s-mer word S.
template <class S>
__host__ __device__ inline size_t ys_bytes(int L) {
  return (size_t)(tile_len<S>(L) + halo<S>()) * sizeof(S);
}

template <class S>
__host__ __device__ inline Layout smem_layout(int L, size_t sort_bytes) {
  Layout o;
  o.words = kHeader;
  o.bits = o.words + align16((size_t)taxor::staged_words(L) * 4);
  o.region = o.bits + align16((size_t)3 * ((L + 31) / 32) * 4);
  const size_t ys = ys_bytes<S>(L);
  o.total = o.region + (sort_bytes > ys ? sort_bytes : ys);
  return o;
}

// The row a block takes: block b is piece b % P of read b / P, the Lp
// bases from base j * stride of the read's packed row of L bases (P = 1:
// the whole row, Lp = L).  Piece j of a read of n bases exists where j <
// pieces(n) (1 for n <= Lp, else 1 + ceil((n - Lp) / stride)); it owns the
// windows (k-mer ends, row positions) [k-1, own): stride + k - 1 bases of
// them where a piece follows, else all of its length, so the pieces'
// owned windows partition the read's.
struct Row {
  const uint32_t* words;  // the row's first packed word
  const uint32_t* read;   // the read's first packed word
  int read_words;         // packed words of the read's row (L / 16)
  int base;               // the row's first base in the read
  int len;                // bases of the read in the row, 0..Lp
  int own;                // the owned windows end here
};

__device__ inline Row row_of(const uint8_t* packed, const int32_t* lengths,
                             int b, int L, int P, int Lp, int stride,
                             int k) {
  const int r = b / P, j = b % P;
  Row o;
  o.read = reinterpret_cast<const uint32_t*>(packed + (size_t)r * (L / 4));
  o.read_words = L / 16;
  o.base = j * stride;
  o.words = o.read + o.base / 16;
  const int n = max(0, min(lengths[r], L));
  const int pieces = n <= Lp ? 1 : 1 + (n - Lp + stride - 1) / stride;
  o.len = j < pieces ? min(Lp, n - o.base) : 0;
  o.own = j < pieces - 1 ? stride + k - 1 : o.len;
  return o;
}

// Step 3 for the windows [i0, i1) (i1 - i0 a multiple of the block, so
// that every lane of a warp ballots): one ballot word per 32 positions of
// each outcome, from the canonical s-mers ys(e).
template <class Ys>
__device__ __forceinline__ void classify(Ys&& ys, int i0, int i1, int Lp,
                                         int len, int k, int s, int t,
                                         uint32_t* emit, uint32_t* tied,
                                         uint32_t* uncertain) {
  const int lane = threadIdx.x & 31;
  for (; i0 < i1; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    taxor::Window o = {false, false, false};
    if (i >= k - 1 && i < len) o = taxor::window_outcome(ys, i, k, s, t);
    const uint32_t e = __ballot_sync(0xFFFFFFFFu, o.emit);
    const uint32_t d = __ballot_sync(0xFFFFFFFFu, o.tied);
    const uint32_t u = __ballot_sync(0xFFFFFFFFu, o.uncertain);
    if (lane == 0 && i < Lp) {
      emit[i >> 5] = e;
      tied[i >> 5] = d;
      uncertain[i >> 5] = u;
    }
  }
}

// Steps 1-4 for the row: stages the words into sw, computes ys and the
// emission mask emit (ceil(Lp/32) words, exact, zero outside the owned
// windows [k-1, own)), using tied and uncertain as scratch masks; found is
// a shared int.  S: the s-mer word.  Ends with a barrier.
template <class S>
__device__ void emission_mask(const Row& row, int Lp, int k, int s, int t,
                              uint32_t* sw, S* ys, uint32_t* emit,
                              uint32_t* tied, uint32_t* uncertain,
                              int* found) {
  // 1. stage the row: kBias/16 zero words, the Lp/16 words, two zero words
  const int nsw = taxor::staged_words(Lp), head = taxor::kBias / 16;
  for (int j = threadIdx.x; j < nsw; j += blockDim.x)
    sw[j] = j >= head && j < head + Lp / 16 ? row.words[j - head] : 0u;
  const int len = row.len;
  __syncthreads();

  // 2-3 a tile at a time: ys[e - base + H] for e in [base - H, base +
  // tile), the canonical s-mers (those ending before s-1 are never read),
  // then the window outcomes, one ballot word per 32 positions
  const int tile = tile_len<S>(Lp);
  constexpr int H = halo<S>();
  for (int base = 0; base < Lp; base += tile) {
    const int end = min(base + tile, len);
    for (int e = max(0, base - H) + threadIdx.x; e < end; e += blockDim.x)
      ys[e - base + H] = taxor::canon_smer<S>(sw, e, s);
    __syncthreads();
    classify([&](int e) { return ys[e - base + H]; }, base,
             min(base + tile, Lp), Lp, len, k, s, t, emit, tied, uncertain);
    __syncthreads();
  }

  // a piece whose first window is tied starts from the read's holder there
  int init = -1;
  if (row.base > 0 && ((tied[(k - 1) >> 5] >> ((k - 1) & 31)) & 1u)) {
    const uint32_t* rd = row.read;
    const int nrw = row.read_words;
    const auto words = [&](int j) {
      return j >= head && j < head + nrw ? rd[j - head] : 0u;
    };
    const auto read_ys = [&](int e) {
      return taxor::canon_smer_at<S>(words, e, s);
    };
    const int qp = taxor::holder_at(read_ys, row.base + k - 1, k, s, t,
                                    found);
    if (threadIdx.x == 0) *found = qp - row.base;
    __syncthreads();
    init = *found;
  }

  // 4. the uncertain windows, exactly
  if (Lp <= tile) {
    taxor::resolve_tied_runs([&](int e) { return ys[e + H]; }, tied,
                             uncertain, emit, len, k, s, t, init);
  } else {  // ys holds the last tile only: recompute
    taxor::resolve_tied_runs(
        [&](int e) { return taxor::canon_smer<S>(sw, e, s); }, tied,
        uncertain, emit, len, k, s, t, init);
  }
  __syncthreads();
  // the windows past the owned ones belong to the next piece
  if (row.own < len) {
    for (int j = threadIdx.x; j < (len + 31) / 32; j += blockDim.x) {
      const int lo = 32 * j;
      if (lo + 32 <= row.own) continue;
      emit[j] &= row.own <= lo ? 0u : (1u << (row.own - lo)) - 1u;
    }
    __syncthreads();
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads) syncmer_extract_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int P, int Lp, int stride, int k, int s, int t, int hcap, int W,
    unsigned long long* __restrict__ scratch, int32_t* __restrict__ out_hi,
    int32_t* __restrict__ out_lo, uint8_t* __restrict__ out_valid,
    int32_t* __restrict__ n_unique_out, int32_t* __restrict__ n_emit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;  // the output row: the block's piece
  const Layout o = smem_layout<S>(Lp, 0);
  int* warp_tot = reinterpret_cast<int*>(smem);
  int* counters = warp_tot + kWarps;  // n_emit, n_unique, found
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem + o.words);
  const int nw = (Lp + 31) / 32;
  uint32_t* emit = reinterpret_cast<uint32_t*>(smem + o.bits);
  S* ys = reinterpret_cast<S*>(smem + o.region);
  unsigned long long* buf =
      scratch ? scratch + (size_t)r * W
              : reinterpret_cast<unsigned long long*>(smem + o.region);

  // 1-4. the exact emission mask; ys is dead afterwards, buf may reuse it
  const Row row = row_of(packed, lengths, r, L, P, Lp, stride, k);
  emission_mask(row, Lp, k, s, t, sw, ys, emit, emit + nw, emit + 2 * nw,
                counters + 2);

  // 5. gather the emitted k-mers in position order: thread j owns the
  // contiguous words [j*per, (j+1)*per), an exclusive block-wide prefix
  // sum over their popcounts gives its first slot
  const int per = (nw + kThreads - 1) / kThreads;
  const int w0 = min(nw, threadIdx.x * per), w1 = min(nw, w0 + per);
  int c = 0;
  for (int j = w0; j < w1; ++j) c += __popc(emit[j]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = c;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  if (threadIdx.x == 0) counters[1] = 0;
  __syncthreads();
  int off = incl - c, n = 0;
  for (int v = 0; v < kWarps; ++v) {
    if (v < warp) off += warp_tot[v];
    n += warp_tot[v];
  }
  for (int j = w0; j < w1; ++j) {
    for (uint32_t bits = emit[j]; bits; bits &= bits - 1) {
      const int i = 32 * j + __ffs(bits) - 1;
      if (off < W) buf[off] = taxor::canon_kmer(sw, i, k);
      ++off;
    }
  }
  __syncthreads();

  // sort, first occurrences, wyhash
  const int m = min(n, W);
  const int Pw = taxor::pow2_at_least(m);
  for (int i = m + threadIdx.x; i < Pw; i += blockDim.x)
    buf[i] = taxor::kSentinel;
  __syncthreads();
  taxor::bitonic_sort(buf, Pw);
  int local = 0;
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    local += (j == 0 || buf[j] != buf[j - 1]);
  atomicAdd(&counters[1], local);  // integer sum: order-free
  for (int j = threadIdx.x; j < hcap; j += blockDim.x) {
    const size_t q = (size_t)r * hcap + j;
    const bool v = j < m && (j == 0 || buf[j] != buf[j - 1]);
    const uint64_t h = v ? taxor::wyhash64(buf[j]) : 0;
    out_hi[q] = (int32_t)(uint32_t)(h >> 32);
    out_lo[q] = (int32_t)(uint32_t)h;
    out_valid[q] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    n_unique_out[r] = counters[1];
    n_emit_out[r] = n;
  }
}

template <class S>
__global__ void __launch_bounds__(kThreads) syncmer_track_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int P, int Lp, int stride, int k, int s, int t,
    int64_t* __restrict__ out_kmer, uint8_t* __restrict__ out_emit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  const Layout o = smem_layout<S>(Lp, 0);
  int* found = reinterpret_cast<int*>(smem);
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem + o.words);
  const int nw = (Lp + 31) / 32;
  uint32_t* emit = reinterpret_cast<uint32_t*>(smem + o.bits);
  S* ys = reinterpret_cast<S*>(smem + o.region);
  const Row row = row_of(packed, lengths, r, L, P, Lp, stride, k);
  emission_mask(row, Lp, k, s, t, sw, ys, emit, emit + nw, emit + 2 * nw,
                found);
  const size_t out = (size_t)r * Lp;
  for (int i = threadIdx.x; i < Lp; i += blockDim.x) {
    out_kmer[out + i] = (int64_t)taxor::canon_kmer(sw, i, k);
    out_emit[out + i] = (emit[i >> 5] >> (i & 31)) & 1u;
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <class S>
cudaError_t extract_launch(const void* packed, const void* lengths, int R,
                           int L, int P, int Lp, int stride, int k, int s,
                           int t, int hcap, int W, void* scratch,
                           void* out_hi, void* out_lo, void* out_valid,
                           void* n_unique, void* n_emit, void* stream) {
  const size_t smem =
      smem_layout<S>(Lp, scratch ? 0 : (size_t)W * 8).total;
  cudaError_t e = set_smem((const void*)syncmer_extract_kernel<S>, smem);
  if (e != cudaSuccess) return e;
  syncmer_extract_kernel<S><<<R * P, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, P, Lp, stride, k, s, t, hcap,
      W, static_cast<unsigned long long*>(scratch),
      static_cast<int32_t*>(out_hi), static_cast<int32_t*>(out_lo),
      static_cast<uint8_t*>(out_valid), static_cast<int32_t*>(n_unique),
      static_cast<int32_t*>(n_emit));
  return cudaGetLastError();
}

template <class S>
cudaError_t track_launch(const void* packed, const void* lengths, int R,
                         int L, int P, int Lp, int stride, int k, int s,
                         int t, void* out_kmer, void* out_emit,
                         void* stream) {
  const size_t smem = smem_layout<S>(Lp, 0).total;
  cudaError_t e = set_smem((const void*)syncmer_track_kernel<S>, smem);
  if (e != cudaSuccess) return e;
  syncmer_track_kernel<S><<<R * P, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, P, Lp, stride, k, s, t,
      static_cast<int64_t*>(out_kmer), static_cast<uint8_t*>(out_emit));
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory K1 takes at row length Lp and s-mer length s
// with a W-key sort buffer in shared memory (in_smem != 0) or in global
// scratch (in_smem == 0).  The wrapper passes scratch when the first
// exceeds what a block may use.
extern "C" int syncmer_extract_smem(int Lp, int s, int W, int in_smem) {
  const size_t sort = in_smem ? (size_t)W * 8 : 0;
  return (int)(s <= 15 ? smem_layout<uint32_t>(Lp, sort)
                       : smem_layout<uint64_t>(Lp, sort))
      .total;
}

// Both launchers take R reads of L bases (packed [R, L/4]) as P pieces
// each of Lp bases, stride apart (P = 1: whole rows, Lp = L), one block and
// one output row a piece: R * P rows.  The instance follows s: 32-bit
// s-mers for s <= 15, 64-bit ones for 16 <= s <= 31.
extern "C" int launch_syncmer_extract(const void* packed, const void* lengths,
                                      int R, int L, int P, int Lp,
                                      int stride, int k, int s, int t,
                                      int hcap, int W, void* scratch,
                                      void* out_hi, void* out_lo,
                                      void* out_valid, void* n_unique,
                                      void* n_emit, void* stream) {
  if (R == 0) return 0;
  const auto launch = s <= 15 ? &extract_launch<uint32_t>
                              : &extract_launch<uint64_t>;
  return (int)launch(packed, lengths, R, L, P, Lp, stride, k, s, t, hcap, W,
                     scratch, out_hi, out_lo, out_valid, n_unique, n_emit,
                     stream);
}

extern "C" int launch_syncmer_track(const void* packed, const void* lengths,
                                    int R, int L, int P, int Lp, int stride,
                                    int k, int s, int t, void* out_kmer,
                                    void* out_emit, void* stream) {
  if (R == 0) return 0;
  const auto launch = s <= 15 ? &track_launch<uint32_t>
                              : &track_launch<uint64_t>;
  return (int)launch(packed, lengths, R, L, P, Lp, stride, k, s, t, out_kmer,
                     out_emit, stream);
}
