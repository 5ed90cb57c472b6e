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
// int64 (the 32-bit ones zero-extended).  emit and pre run the sequential
// reference tracker (tracker.cuh track_syncmers), one thread per read:
// K1 and syncmer_track classify windows in parallel and replay the same
// step rule only inside tied runs, so this is what they are bisected
// against; the other stages are per position, in parallel, from the
// staged 2-bit words.
//
// window_shift replaces tools/debug_min.py (kern): for each phase c,
// off = 2c - 22, jb = floor(off / 32), sh = off - 32 jb; the row of stream
// words is rolled left by jb + 1 words (np.roll by -(jb+1)) and, if sh,
// shifted left by 32 - sh and masked to 24 bits; phase-major output.
//
// What bounds them on the H100: extract_stages writes 8 bytes per
// position, and its emit and pre stages run the sequential tracker;
// window_shift is bound by its bytes.
#include <cuda_runtime.h>

#include <cstdint>

#include "../tracker.cuh"

namespace {

constexpr int kThreads = 256;

enum Stage {
  kSf = 0, kSr, kYs, kKf, kKr, kChi, kClo, kErm, kEmit, kPre
};

// (forward, reverse-complement) m-mer ending at base i, bases before 0 as
// A: forward has the newest base lowest, reverse the complement of the
// newest base highest (the reference's rolling registers).
__device__ inline void mer_at(const uint32_t* words, int i, int m,
                              uint64_t& f, uint64_t& rv) {
  f = 0;
  rv = 0;
  for (int j = 0; j < m; ++j) {
    const int p = i - j;
    const uint32_t c = p >= 0 ? taxor::base_at(words, p) : 0u;
    f |= (uint64_t)c << (2 * j);
    rv |= (uint64_t)(3u - c) << (2 * (m - 1 - j));
  }
}

__device__ inline uint32_t ys_at(const uint32_t* words, int i, int s) {
  if (i < s - 1) return 0xFFFFFFFFu;
  uint64_t f, rv;
  mer_at(words, i, s, f, rv);
  return (uint32_t)(f < rv ? f : rv);
}

__global__ void __launch_bounds__(kThreads) extract_stage_kernel(
    const uint8_t* __restrict__ packed, const int32_t* __restrict__ lengths,
    int L, int k, int s, int t, int stage, int64_t* __restrict__ out,
    uint8_t* __restrict__ out_emit) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = blockIdx.x;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint32_t* ring = words + L / 16;
  uint32_t* bits = ring + 32;  // emission mask, ceil(L/32) words
  int* count = reinterpret_cast<int*>(bits + (L + 31) / 32);
  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(packed + (size_t)r * (L / 4));
  for (int i = threadIdx.x; i < L / 16; i += blockDim.x) words[i] = src[i];
  for (int i = threadIdx.x; i < (L + 31) / 32; i += blockDim.x) bits[i] = 0;
  __syncthreads();
  const size_t row = (size_t)r * L;
  const int w = k - s + 1;

  if (stage == kEmit || stage == kPre) {
    if (threadIdx.x == 0) {
      const int len = max(0, min(lengths[r], L));
      *count = taxor::track_syncmers(
          words, ring, len, k, s, t, [&](int n, int i, uint64_t kmer) {
            if (stage == kPre) out[row + n] = (int64_t)kmer;
            bits[i >> 5] |= 1u << (i & 31);
          });
    }
    __syncthreads();
    for (int i = threadIdx.x; i < L; i += blockDim.x) {
      if (stage == kEmit)
        out_emit[row + i] = (bits[i >> 5] >> (i & 31)) & 1u;
      else if (i >= *count)
        out[row + i] = -1;  // all ones: past the emissions
    }
    return;
  }

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    uint64_t v, f, rv;
    switch (stage) {
      case kSf:
      case kSr:
        mer_at(words, i, s, f, rv);
        v = stage == kSf ? f : rv;
        break;
      case kYs:
        v = ys_at(words, i, s);
        break;
      case kKf:
      case kKr:
        mer_at(words, i, k, f, rv);
        v = stage == kKf ? f : rv;
        break;
      case kChi:
      case kClo:
        mer_at(words, i, k, f, rv);
        v = f < rv ? f : rv;
        v = stage == kChi ? v >> 32 : v & 0xFFFFFFFFull;
        break;
      default: {  // kErm: scanning leftwards, only a strict < moves it
        uint32_t best = ys_at(words, i, s);
        int at = i;
        for (int j = i - 1; j >= max(0, i - w + 1); --j) {
          const uint32_t y = ys_at(words, j, s);
          if (y < best) {
            best = y;
            at = j;
          }
        }
        v = (uint64_t)at;
      }
    }
    out[row + i] = (int64_t)v;
  }
}

__global__ void window_shift_kernel(const uint32_t* __restrict__ x, int R,
                                    int Wd, const int32_t* __restrict__ phases,
                                    int P, uint32_t* __restrict__ out) {
  const size_t total = (size_t)R * P * Wd;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % Wd);
    const int pi = (int)((idx / Wd) % P);
    const size_t r = idx / ((size_t)Wd * P);
    const int off = 2 * phases[pi] - 22;
    const int jb = off >= 0 ? off / 32 : -((31 - off) / 32);  // floor
    const int sh = off - 32 * jb;                              // 0..31
    const int src = (int)((((long long)j + jb + 1) % Wd + Wd) % Wd);
    uint32_t v = x[r * Wd + src];
    if (sh) v = (v << (32 - sh)) & 0xFFFFFFu;
    out[idx] = v;
  }
}

}  // namespace

// packed: uint8 [R, L/4] (pack_reads); lengths: int32 [R]; out: int64
// [R, L] for every stage but emit, out_emit: uint8 [R, L] for emit.
extern "C" int launch_extract_stage(const void* packed, const void* lengths,
                                    int R, int L, int k, int s, int t,
                                    int stage, void* out, void* out_emit,
                                    void* stream) {
  if (stage < kSf || stage > kPre) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const size_t smem =
      (size_t)(L / 4) + 32 * 4 + 4 * (size_t)((L + 31) / 32) + 16;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)extract_stage_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  extract_stage_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const int32_t*>(lengths), L, k, s, t, stage,
      static_cast<int64_t*>(out), static_cast<uint8_t*>(out_emit));
  return (int)cudaGetLastError();
}

// x: int32 [R, Wd] stream words; phases: int32 [P] (on the device); out:
// int32 [R, P * Wd].
extern "C" int launch_window_shift(const void* x, int R, int Wd,
                                   const void* phases, int P, void* out,
                                   void* stream) {
  const size_t total = (size_t)R * P * Wd;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads < 65536
                               ? (total + threads - 1) / threads
                               : 65536);
  window_shift_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), R, Wd,
      static_cast<const int32_t*>(phases), P, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
