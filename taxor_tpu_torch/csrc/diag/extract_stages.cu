// Extractor stage dumps and the window-shift repro: the bisecting tools
// of the syncmer extractor.
//
// extract_stages replaces the TPU diagnostic tools/debug_extract.py
// (run, _stage_kernel), which dumped one intermediate of the TPU
// extractor per run in its 16-phase word layout.  Here one launch dumps
// one stage of read r in POSITION order, out[r, i] for base i < L:
//   sf, sr    forward / reverse-complement s-mer ending at i
//   ys        canonical s-mer min(sf, sr); 0xFFFFFFFF where i < s-1
//   kf, kr    forward / reverse-complement k-mer ending at i
//   chi, clo  high / low 32 bits of the canonical k-mer min(kf, kr)
//   erm       end position of the rightmost minimum of ys over the
//             window [max(0, i-w+1), i], w = k-s+1
//   emit      the tracker's emission mask (uint8; false past the length)
//   pre       the emitted canonical k-mers in emission order, all ones
//             past the emission count (before K1's sort)
// Bases before 0 read as A (the port's kmer_at and _rolling).  Values are
// int64 (the 32-bit ones zero-extended).
//
// The eight per-position stages (stage_tile_kernel) take a block per
// tile of kTile positions of a read: the tile's 2-bit words staged in
// shared memory with zero words before (bases before 0 read as A), every
// m-mer a funnel shift of two or three staged words (pair16, pair32), a
// thread two neighbouring positions and one 16-byte store.  erm first
// writes the tile's ys, and kHalo before it, into shared memory, then
// scans its w values there.  They are bound by the bytes they write, 8
// a position.
//
// emit and pre (walk_kernel) run the reference tracker's step rule
// (tracker.cuh tracker_step) over every window of a read, in order, on
// ONE thread of the read's block: the sequential rule that K1 and
// syncmer_track, which classify windows in parallel and replay the rule
// only inside tied runs, are bisected against.  Everything that does not
// depend on the held minimum leaves that chain: the block's other warps
// compute the canonical s-mers one chunk ahead into a ring in shared
// memory, the walking thread takes them eight at a time in registers
// (the loads of the next eight issued before the steps of these), keeps
// the emission mask and its running count, and the block then writes
// the emitted k-mers at their ranks with coalesced stores.  The kernel
// is compiled for each window width w, so tracker_step's scans of w
// s-mers unroll, and the groups past the first window and short of the
// read's end drop its first-window and bounds tests.  What remains
// bounds it: one read's dependent chain of L steps, each a compare and
// a select on the held minimum and a branch on its slide-out (~118
// clocks a step on the H100, PERF.md), not its bytes.
//
// window_shift replaces tools/debug_min.py (kern): for each phase c,
// off = 2c - 22, jb = floor(off / 32), sh = off - 32 jb; the row of stream
// words is rolled left by jb + 1 words (np.roll by -(jb+1)) and, if sh,
// shifted left by 32 - sh and masked to 24 bits; phase-major output.  A
// block per (eight rows, phase), a warp a row; each phase's roll and
// shift come by value from the host, no division on the card; a thread
// writes four output words in one 16-byte store.  Bound by its bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "../tracker.cuh"

namespace {

constexpr int kThreads = 256;

enum Stage {
  kSf = 0, kSr, kYs, kKf, kKr, kChi, kClo, kErm, kEmit, kPre
};

// ------------------------------------------------ per-position stages --

constexpr int kTile = 1024;  // positions a block
constexpr int kLead = 4;     // zero words staged before a tile: 64 bases
constexpr int kHalo = 32;    // erm: ys ends before the tile (>= w - 1)
constexpr int kTileWords = kLead + kTile / 16 + 2;

// The staged words hold the oldest base lowest; the reference's forward
// register holds the newest base lowest.  So for the m bases from staged
// base q on, raw = the staged bits: reverse complement = ~raw (masked),
// forward = the 2-bit fields of raw reversed (as tracker.cuh canon_smer
// and canon_kmer, but both halves kept).

// m <= 15: two staged words.
__device__ __forceinline__ void pair16(const uint32_t* sw, int q, int m,
                                       uint32_t& f, uint32_t& rc) {
  const uint32_t raw =
      __funnelshift_r(sw[q >> 4], sw[(q >> 4) + 1], 2 * (q & 15));
  f = taxor::rev2_32(raw) >> (32 - 2 * m);
  rc = ~raw & ((1u << (2 * m)) - 1);
}

// m <= 32: three staged words.
__device__ __forceinline__ void pair32(const uint32_t* sw, int q, int m,
                                       uint64_t& f, uint64_t& rc) {
  const uint32_t* p = sw + (q >> 4);
  const int sh = 2 * (q & 15);
  const uint32_t lo = __funnelshift_r(p[0], p[1], sh);
  const uint32_t hi = __funnelshift_r(p[1], p[2], sh);
  const uint64_t mask = m == 32 ? ~0ull : (1ull << (2 * m)) - 1;
  rc = ~(((uint64_t)hi << 32) | lo) & mask;
  f = (((uint64_t)taxor::rev2_32(lo) << 32) | taxor::rev2_32(hi)) >>
      (64 - 2 * m);
}

// Canonical s-mer ending at base e of the tile from i0; 0xFFFFFFFF where
// e < s-1.
__device__ __forceinline__ uint32_t tile_ys(const uint32_t* sw, int e,
                                            int i0, int s) {
  if (e < s - 1) return 0xFFFFFFFFu;
  uint32_t f, rc;
  pair16(sw, e - i0 + 16 * kLead - s + 1, s, f, rc);
  return f < rc ? f : rc;
}

template <int STAGE>
__device__ __forceinline__ int64_t tile_value(const uint32_t* sw,
                                              const uint32_t* ysb, int i,
                                              int i0, int k, int s) {
  const int q = i - i0 + 16 * kLead;  // staged base of position i
  if (STAGE == kSf || STAGE == kSr) {
    uint32_t f, rc;
    pair16(sw, q - s + 1, s, f, rc);
    return STAGE == kSf ? f : rc;
  } else if (STAGE == kYs) {
    return tile_ys(sw, i, i0, s);
  } else if (STAGE == kErm) {  // scanning leftwards, only a strict < moves it
    const int lo = max(0, i - (k - s));
    uint32_t best = ysb[i - i0 + kHalo];
    int at = i;
    for (int j = i - 1; j >= lo; --j) {
      const uint32_t y = ysb[j - i0 + kHalo];
      if (y < best) {
        best = y;
        at = j;
      }
    }
    return at;
  } else {
    uint64_t f, rc;
    pair32(sw, q - k + 1, k, f, rc);
    if (STAGE == kKf) return (int64_t)f;
    if (STAGE == kKr) return (int64_t)rc;
    const uint64_t c = f < rc ? f : rc;
    return STAGE == kChi ? (int64_t)(c >> 32) : (int64_t)(c & 0xFFFFFFFFull);
  }
}

// grid (R, tiles): block (r, y) writes positions [y kTile, (y+1) kTile)
// of read r.
template <int STAGE>
__global__ void __launch_bounds__(kThreads) stage_tile_kernel(
    const uint8_t* __restrict__ packed, int L, int k, int s,
    int64_t* __restrict__ out) {
  __shared__ uint32_t sw[kTileWords];
  __shared__ uint32_t ysb[STAGE == kErm ? kHalo + kTile : 1];
  const int r = blockIdx.x;
  const int i0 = blockIdx.y * kTile;
  const int n = min(kTile, L - i0);  // even: L is a multiple of 16
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (L / 4));
  for (int x = threadIdx.x; x < kTileWords; x += kThreads) {
    const int g = i0 / 16 - kLead + x;
    sw[x] = g >= 0 && g < L / 16 ? src[g] : 0u;
  }
  __syncthreads();
  if (STAGE == kErm) {
    for (int h = threadIdx.x; h < kHalo + n; h += kThreads)
      ysb[h] = tile_ys(sw, i0 - kHalo + h, i0, s);
    __syncthreads();
  }
  int64_t* row = out + (size_t)r * L + i0;
  for (int p = 2 * threadIdx.x; p < n; p += 2 * kThreads) {
    longlong2 v;
    v.x = tile_value<STAGE>(sw, ysb, i0 + p, i0, k, s);
    v.y = tile_value<STAGE>(sw, ysb, i0 + p + 1, i0, k, s);
    *reinterpret_cast<longlong2*>(row + p) = v;
  }
}

// ------------------------------------------------------ emit and pre --

constexpr int kChunk = 1024;        // s-mers the producers compute a round
constexpr int kRing = 4 * kChunk;   // the walker's chunk, the one before,
                                    // the producers' next (and one spare)
constexpr int kGroup = 8;           // steps the walker takes a register load

// Dynamic shared memory of walk_kernel: the ys ring (later the emitted
// positions), the mask and its prefix counts (a word each 32 bases), the
// staged words.  diag.stage_smem mirrors it.
__host__ __device__ inline size_t walk_smem(int L) {
  const int nmw = (L + 31) / 32;
  return 4 * ((size_t)kRing + 2 * nmw + taxor::staged_words(L));
}

__device__ __forceinline__ void load_group(const uint32_t* ring, int b,
                                           uint32_t (&y)[kGroup]) {
  const uint4* p = reinterpret_cast<const uint4*>(ring + (b & (kRing - 1)));
  const uint4 a = p[0], c = p[1];
  y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w;
  y[4] = c.x, y[5] = c.y, y[6] = c.z, y[7] = c.w;
}

// W > 0: the window's width w = k - s + 1 as a constant, k read as
// s + W - 1, so that tracker_step's scans of w s-mers unroll and their
// loads issue together; W = 0 takes k as given.
template <int W>
__global__ void __launch_bounds__(kThreads) walk_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int k_in, int s, int t, int stage, int64_t* __restrict__ out,
    uint8_t* __restrict__ out_emit) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int k = W ? s + W - 1 : k_in;
  const int nmw = (L + 31) / 32;
  uint32_t* ring = smem;
  uint32_t* mask = ring + kRing;
  int* prefix = reinterpret_cast<int*>(mask + nmw);
  uint32_t* sw = reinterpret_cast<uint32_t*>(prefix + nmw);
  __shared__ int count;
  const int r = blockIdx.x;
  const int len = max(0, min(lengths[r], L));
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (L / 4));
  for (int x = threadIdx.x; x < taxor::staged_words(L); x += kThreads)
    sw[x] = x >= 2 && x < 2 + L / 16 ? src[x - 2] : 0u;
  for (int x = threadIdx.x; x < nmw; x += kThreads) mask[x] = 0;
  __syncthreads();

  // producers (warps 1-7): the s-mers ending in chunk c, into its slot
  const auto produce = [&](int c) {
    const int lo = max(c * kChunk, s - 1), hi = min((c + 1) * kChunk, len);
    for (int e = lo + threadIdx.x - 32; e < hi; e += kThreads - 32)
      ring[e & (kRing - 1)] = taxor::canon_smer(sw, e, s);
  };
  const int nc = (len + kChunk - 1) / kChunk;
  if (threadIdx.x >= 32 && nc) produce(0);
  __syncthreads();
  uint32_t qv = 0xFFFFFFFFu;  // the walker's held minimum ...
  int qp = -1, n = 0;         // ... its s-mer start, the emissions so far
  for (int c = 0; c < nc; ++c) {
    if (threadIdx.x == 0) {
      const int end = min((c + 1) * kChunk, len);
      uint32_t y[kGroup], next[kGroup], m = 0;
      load_group(ring, c * kChunk, y);
      for (int b = c * kChunk; b < end; b += kGroup) {
        load_group(ring, b + kGroup, next);  // unused past the chunk
        if (b >= k && b + kGroup <= end) {  // past the first window, whole
#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            const int i = b + j;
            __builtin_assume(i > k - 1);
            const uint32_t yi = y[j];
            const auto ys = [&](int e) {
              return e == i ? yi : ring[e & (kRing - 1)];
            };
            if (taxor::tracker_step(i, k, s, t, ys, qv, qp))
              m |= 1u << (i & 31);
          }
        } else {  // the read's first and last groups: from the ring
          const auto ys = [&](int e) { return ring[e & (kRing - 1)]; };
#pragma unroll 1
          for (int i = max(b, k - 1); i < min(b + kGroup, end); ++i)
            if (taxor::tracker_step(i, k, s, t, ys, qv, qp))
              m |= 1u << (i & 31);
        }
        if (((b + kGroup) & 31) == 0 || b + kGroup >= end) {
          mask[b >> 5] = m;
          prefix[b >> 5] = n;
          n += __popc(m);
          m = 0;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) y[j] = next[j];
      }
      count = n;
    } else if (threadIdx.x >= 32 && c + 1 < nc) {
      produce(c + 1);
    }
    __syncthreads();
  }
  if (nc == 0 && threadIdx.x == 0) count = 0;
  __syncthreads();
  const int total = count;
  const size_t row = (size_t)r * L;

  if (stage == kEmit) {  // the mask as bytes, 16 positions a store
    for (int p = 16 * threadIdx.x; p < L; p += 16 * kThreads) {
      const uint32_t bits = mask[p >> 5] >> (p & 31);
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t nib = bits >> (4 * q);
        v[q] = (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
               ((nib & 8u) << 21);
      }
      *reinterpret_cast<uint4*>(out_emit + row + p) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
    return;
  }

  // pre: the emitted positions of kRing bases at a time into the ring, at
  // their ranks, then their k-mers written in rank order
  const int nwalk = (len + 31) / 32;
  constexpr int kWords = kRing / 32;  // mask words a round
  for (int w0 = 0; w0 < nwalk; w0 += kWords) {
    const int n0 = prefix[w0];
    const int wi = w0 + threadIdx.x;
    if (threadIdx.x < kWords && wi < nwalk) {
      uint32_t m = mask[wi];
      int o = prefix[wi] - n0;
      while (m) {
        ring[o++] = 32 * wi + __ffs(m) - 1;
        m &= m - 1;
      }
    }
    __syncthreads();
    const int cnt = (w0 + kWords < nwalk ? prefix[w0 + kWords] : total) - n0;
    for (int j = threadIdx.x; j < cnt; j += kThreads)
      out[row + n0 + j] = (int64_t)taxor::canon_kmer(sw, ring[j], k);
    __syncthreads();
  }
  for (int p = 2 * threadIdx.x; p < L; p += 2 * kThreads) {  // -1 past them
    if (p >= total)
      *reinterpret_cast<longlong2*>(out + row + p) = make_longlong2(-1, -1);
    else if (p + 1 == total)
      out[row + p + 1] = -1;
  }
}

// ------------------------------------------------------- window shift --

constexpr int kMaxPhases = 64;  // phases a launch
constexpr int kShiftRows = 8;   // rows a block, a warp each

struct Phases {
  int2 p[kMaxPhases];  // (d, sh): source word j + d mod Wd, shift sh
};

// grid (row blocks, phases of this launch); out row r, phase block pi0 +
// blockIdx.y.
__global__ void __launch_bounds__(32 * kShiftRows) window_shift_kernel(
    const uint32_t* __restrict__ x, int R, int Wd, const Phases ph, int P,
    int pi0, uint32_t* __restrict__ out) {
  const int r = blockIdx.x * kShiftRows + threadIdx.y;
  if (r >= R) return;
  const int d = ph.p[blockIdx.y].x, sh = ph.p[blockIdx.y].y;
  const uint32_t* row = x + (size_t)r * Wd;
  uint32_t* o = out + ((size_t)r * P + pi0 + blockIdx.y) * Wd;
  const auto word = [&](int j) {
    int src = j + d;
    if (src >= Wd) src -= Wd;
    const uint32_t v = __ldg(row + src);
    return sh ? (v << (32 - sh)) & 0xFFFFFFu : v;
  };
  const int lane = threadIdx.x;
  // words before the first 16-byte boundary, the 16-byte units, the tail
  const int head =
      min(Wd, (int)((0u - (uint32_t)(reinterpret_cast<uintptr_t>(o) >> 2)) &
                    3u));
  const int units = (Wd - head) >> 2;
  if (lane < head) o[lane] = word(lane);
  for (int u = lane; u < units; u += 32) {
    const int j = head + 4 * u;
    *reinterpret_cast<uint4*>(o + j) =
        make_uint4(word(j), word(j + 1), word(j + 2), word(j + 3));
  }
  const int tail = head + 4 * units + lane;
  if (lane < 3 && tail < Wd) o[tail] = word(tail);
}

constexpr int kMaxW = 31;  // k <= 32, s >= 2

// walk_kernel<w> for 2 <= w <= kMaxW.
template <int W = 2>
cudaError_t launch_walk(int w, const void* packed, const void* lengths,
                        int R, int L, int k, int s, int t, int stage,
                        void* out, void* out_emit, cudaStream_t stream) {
  if constexpr (W <= kMaxW) {
    if (w != W)
      return launch_walk<W + 1>(w, packed, lengths, R, L, k, s, t, stage,
                                out, out_emit, stream);
  }
  constexpr int V = W <= kMaxW ? W : 0;
  const size_t smem = walk_smem(L);
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)walk_kernel<V>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  walk_kernel<V><<<R, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, k, s, t, stage,
      static_cast<int64_t*>(out), static_cast<uint8_t*>(out_emit));
  return cudaGetLastError();
}

template <int STAGE>
cudaError_t launch_tiles(const void* packed, int R, int L, int k, int s,
                         void* out, cudaStream_t stream) {
  const dim3 grid(R, (L + kTile - 1) / kTile);
  stage_tile_kernel<STAGE><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), L, k, s,
      static_cast<int64_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory bytes of stage's kernel at length L (0 for the
// per-position stages, whose shared memory is static).
extern "C" int extract_stage_smem(int L, int stage) {
  return stage == kEmit || stage == kPre ? (int)walk_smem(L) : 0;
}

// packed: uint8 [R, L/4] (pack_reads); lengths: int32 [R]; out: int64
// [R, L] for every stage but emit, out_emit: uint8 [R, L] for emit; both
// 16-byte aligned.
extern "C" int launch_extract_stage(const void* packed, const void* lengths,
                                    int R, int L, int k, int s, int t,
                                    int stage, void* out, void* out_emit,
                                    void* stream) {
  if (stage < kSf || stage > kPre) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (stage) {
    case kSf: return (int)launch_tiles<kSf>(packed, R, L, k, s, out, st);
    case kSr: return (int)launch_tiles<kSr>(packed, R, L, k, s, out, st);
    case kYs: return (int)launch_tiles<kYs>(packed, R, L, k, s, out, st);
    case kKf: return (int)launch_tiles<kKf>(packed, R, L, k, s, out, st);
    case kKr: return (int)launch_tiles<kKr>(packed, R, L, k, s, out, st);
    case kChi: return (int)launch_tiles<kChi>(packed, R, L, k, s, out, st);
    case kClo: return (int)launch_tiles<kClo>(packed, R, L, k, s, out, st);
    case kErm: return (int)launch_tiles<kErm>(packed, R, L, k, s, out, st);
    default: break;
  }
  return (int)launch_walk(k - s + 1, packed, lengths, R, L, k, s, t, stage,
                          out, out_emit, st);
}

// x: int32 [R, Wd] stream words; phases: int32 [2P] in HOST memory, the
// (d, sh) of each phase block (source word j + d mod Wd, 0 <= d < Wd;
// shift sh, 0 <= sh < 32); out: int32 [R, P * Wd].
extern "C" int launch_window_shift(const void* x, int R, int Wd,
                                   const void* phases, int P, void* out,
                                   void* stream) {
  if ((size_t)R * P * Wd == 0) return 0;
  const int32_t* ph = static_cast<const int32_t*>(phases);
  for (int pi0 = 0; pi0 < P; pi0 += kMaxPhases) {
    const int np = min(kMaxPhases, P - pi0);
    Phases arg{};
    for (int i = 0; i < np; ++i)
      arg.p[i] = make_int2(ph[2 * (pi0 + i)], ph[2 * (pi0 + i) + 1]);
    const dim3 grid((R + kShiftRows - 1) / kShiftRows, np);
    window_shift_kernel<<<grid, dim3(32, kShiftRows), 0,
                          (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(x), R, Wd, arg, P, pi0,
        static_cast<uint32_t*>(out));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
