// The reference's open-canonical-syncmer tracker: its step rule, the
// sequential whole-read tracker built on it, and the parallel decomposition
// that K1 (extract.cu, syncmer_extract) and the split engine's
// syncmer_track (extract.cu) run instead.
//
// The tracker (hash/syncmer.py, src/hashing/syncmer.cpp:109-146): leftmost
// minimum on the first full window; when the held minimum slides out, the
// RIGHTMOST minimum of the new window; otherwise only a strictly smaller
// newcomer takes over.  Emit the k-mer ending at i iff the held s-mer
// starts at i-k+t.  Its replacement on the TPU was the scan-free sliding
// argmin of taxor_tpu/device/pallas_extract.py (_extract_kernel, :19-31
// and :193-226), which flagged reads with tied window minima for the host.
//
// tracker_step is that rule for one window, over any store of s-mers.
// The diagnostic kernel extract_stages.cu (stages emit and pre) applies
// it to every window of a read on ONE thread: the reference tracker to
// bisect against.
//
// The decomposition (window_outcome, resolve_tied_runs) makes the tracker
// position-parallel and exact.  The held value is always the window
// minimum, so after a window whose minimum is unique the holder is that
// argmin, whatever came before.  History matters only inside maximal runs
// of tied windows, and a tied window's emission is uncertain only when
// one of its tied minima sits at the emission offset.  Every window is
// classified in parallel (unique: emit iff the argmin is at the offset;
// tied with no minimum at the offset: no emission; else uncertain); one
// thread per tied run that holds an uncertain window replays tracker_step
// over that run from the unique window before it (or from the first
// window), stepping only where the held minimum slides out.  A read tied
// everywhere (a homopolymer, a short tandem repeat) is one run, replayed
// serially and exactly in hops of up to w windows.
//
// A piece of a longer read (K1's piece rows) starts with the holder the
// whole read has at the piece's first window: where that window's minimum
// is unique it is the argmin; where it is tied, holder_at replays the
// read's tracker from the last unique window before it (or from the
// read's first window), however long the tied stretch, and the piece's
// replay of its first tied run starts from that holder (``init``).
//
// The canonical s-mer is a 32-bit word for s <= 15 and a 64-bit one for
// 16 <= s <= 31 (S below): every function here takes the word type of
// the s-mers it is given, with the same tie rules for both.
#pragma once
#include <cstdint>
#include <type_traits>

namespace taxor {

// One step of the reference tracker at the window of the k-mer ending at
// base i (i >= k-1): updates the held minimum value qv and its s-mer start
// qp, and returns whether that k-mer is emitted.  ys(e) is the canonical
// s-mer ending at base e, read for e in [i-w+1, i], w = k-s+1.  init >= 0
// gives the holder of the first full window (its s-mer start) in place of
// the leftmost minimum: the holder a piece inherits from the whole read.
// S, the s-mer word, is what ys returns; no canonical s-mer is all ones.
template <class Ys, class S>
__device__ __forceinline__ bool tracker_step(int i, int k, int s, int t,
                                             Ys&& ys, S& qv, int& qp,
                                             int init = -1) {
  const int w = k - s + 1;
  if (i == k - 1 && init >= 0) {  // first full window, holder given
    qp = init;
    qv = ys(init + s - 1);
  } else if (i == k - 1) {  // first full window: leftmost minimum
    qv = ~S(0);
    for (int j = 0; j < w; ++j) {
      const S v = ys(s - 1 + j);
      if (v < qv) {
        qv = v;
        qp = j;
      }
    }
  } else if (qp == i - k) {  // the minimum slid out: rightmost minimum
    qv = ~S(0);
    for (int j = w - 1; j >= 0; --j) {
      const S v = ys(i - w + 1 + j);
      if (v < qv) {
        qv = v;
        qp = i - k + 1 + j;
      }
    }
  } else {  // only a strictly smaller newcomer takes over
    const S y = ys(i);
    if (y < qv) {
      qv = y;
      qp = i - s + 1;
    }
  }
  return qp == i - k + t;
}

// ---------------------------------------------------- the decomposition --

// Reads are staged with kBias zero bases (two words) before base 0 and two
// zero words after the last, so every s-mer and k-mer is a funnel shift of
// two or three staged words, bases before 0 reading as A.
constexpr int kBias = 32;

__host__ __device__ inline int staged_words(int L) { return L / 16 + 4; }

// Reverses the 16 2-bit fields of x.
__device__ __forceinline__ uint32_t rev2_32(uint32_t x) {
  const uint32_t b = __brev(x);
  return ((b >> 1) & 0x55555555u) | ((b & 0x55555555u) << 1);
}

// The staged words hold the oldest base lowest; the reference's forward
// register holds the newest base lowest.  So for the m bases ending at i,
// raw = the staged bits: reverse complement = ~raw (masked), forward =
// the 2-bit fields of raw reversed.

// Canonical s-mer ending at base i of staged words read as sw(j) (a read
// in global memory; canon_smer below for an array): for S = uint32_t (s
// <= 15) a funnel shift of two staged words and a 2-bit reversal, for S =
// uint64_t (16 <= s <= 31) of three, as canon_kmer.
template <class S, class Words>
__device__ __forceinline__ S canon_smer_at(Words&& sw, int i, int s) {
  const int q = i - s + 1 + kBias;
  const uint32_t lo =
      __funnelshift_r(sw(q >> 4), sw((q >> 4) + 1), 2 * (q & 15));
  if constexpr (sizeof(S) == 4) {
    const uint32_t smask = (1u << (2 * s)) - 1;
    const uint32_t fwd = rev2_32(lo) >> (32 - 2 * s);
    const uint32_t rc = ~lo & smask;
    return fwd < rc ? fwd : rc;
  } else {
    const uint32_t hi =
        __funnelshift_r(sw((q >> 4) + 1), sw((q >> 4) + 2), 2 * (q & 15));
    const uint64_t smask = (1ull << (2 * s)) - 1;
    const uint64_t rc = ~(((uint64_t)hi << 32) | lo) & smask;
    const uint64_t fwd =
        (((uint64_t)rev2_32(lo) << 32) | rev2_32(hi)) >> (64 - 2 * s);
    return fwd < rc ? fwd : rc;
  }
}

// Canonical s-mer ending at base i of the staged words sw.
template <class S = uint32_t>
__device__ __forceinline__ S canon_smer(const uint32_t* sw, int i, int s) {
  return canon_smer_at<S>([&](int j) { return sw[j]; }, i, s);
}

// Canonical k-mer ending at base i (k <= 32): three staged words.
__device__ __forceinline__ uint64_t canon_kmer(const uint32_t* sw, int i,
                                               int k) {
  const int q = i - k + 1 + kBias;
  const uint32_t* p = sw + (q >> 4);
  const int sh = 2 * (q & 15);
  const uint32_t lo = __funnelshift_r(p[0], p[1], sh);
  const uint32_t hi = __funnelshift_r(p[1], p[2], sh);
  const uint64_t kmask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint64_t rc = ~(((uint64_t)hi << 32) | lo) & kmask;
  const uint64_t fwd =
      (((uint64_t)rev2_32(lo) << 32) | rev2_32(hi)) >> (64 - 2 * k);
  return fwd < rc ? fwd : rc;
}

// The s-mer word an accessor ys(e) returns.
template <class Ys>
using smer_of = std::decay_t<decltype(std::declval<Ys>()(0))>;

// The outcome of the window of the k-mer ending at i (k-1 <= i < len),
// from the canonical s-mers ys(e) (by end base): a direct scan for the
// minimum and its leftmost and rightmost argmin.
struct Window {
  bool emit;       // unique minimum at the emission offset
  bool tied;       // the minimum occurs more than once
  bool uncertain;  // tied, and one of the minima is at the offset
};

template <class Ys>
__device__ __forceinline__ Window window_outcome(Ys&& ys, int i, int k, int s,
                                                 int t) {
  using S = smer_of<Ys>;
  const int w = k - s + 1;
  S m = ~S(0);
  int lm = 0, rm = 0;
  for (int e = i - w + 1; e <= i; ++e) {
    const S y = ys(e);
    if (y < m) {
      m = y;
      lm = e;
      rm = e;
    } else if (y == m) {
      rm = e;
    }
  }
  const int off = i - w + t;  // end of the s-mer starting at i-k+t
  const bool tied = lm != rm;
  return {!tied && lm == off, tied, tied && ys(off) == m};
}

// Step 4: every maximal run of tied windows that holds an uncertain
// window is replayed with tracker_step by one thread, from the unique
// window before it (a held minimum that has just slid out rescans that
// window, whose rightmost minimum is its only one) or from the first
// window, up to its last uncertain window; emissions are OR-ed into emit.
// Inside a tied run no newcomer is strictly smaller than the held minimum
// (it would be its window's only minimum), so the holder changes only
// where it slides out: the replay steps there, hops of up to w windows,
// and marks the one window in between where the holder sits at the
// offset.  tied, uncertain and emit are bit masks, bit i%32 of word i/32,
// zero at every i outside [k-1, len).  init: the holder of the first
// window (tracker_step), -1 for the leftmost minimum.  ys(e): the
// canonical s-mers.  Every thread of the block calls it.
template <class Ys>
__device__ inline void resolve_tied_runs(Ys&& ys, const uint32_t* tied,
                                         const uint32_t* uncertain,
                                         uint32_t* emit, int len, int k,
                                         int s, int t, int init = -1) {
  const int nw = (len + 31) / 32;
  for (int j = threadIdx.x; j < nw; j += blockDim.x) {
    const uint32_t tj = tied[j];
    uint32_t starts = tj & ~((tj << 1) | (j ? tied[j - 1] >> 31 : 0u));
    while (starts) {
      const int b = __ffs(starts) - 1;
      starts &= starts - 1;
      const int a = 32 * j + b;  // the run's first window
      int last = -1;             // its last uncertain window
      for (int q = j, lo = b; q < nw; ++q, lo = 0) {
        const uint32_t from = ~0u << lo;
        const uint32_t ends = ~tied[q] & from;
        const uint32_t in_run =
            ends ? from & ((1u << (__ffs(ends) - 1)) - 1u) : from;
        const uint32_t u = uncertain[q] & in_run;
        if (u) last = 32 * q + 31 - __clz(u);
        if (ends) break;
      }
      if (last < 0) continue;
      smer_of<Ys> qv = 0;
      int qp = a - 1 - k;  // as if the held minimum had just slid out
      // only the first step can be the first window, the one init
      // concerns: the later steps leave it out of their serial chain
      int i = a == k - 1 ? a : a - 1;
      bool hit = tracker_step(i, k, s, t, ys, qv, qp, init);
      for (;;) {
        if (hit) atomicOr(&emit[i >> 5], 1u << (i & 31));
        const int e = qp + k - t;  // the window where the holder emits
        if (e > i && e <= last) atomicOr(&emit[e >> 5], 1u << (e & 31));
        i = qp + k;
        if (i > last) break;
        hit = tracker_step(i, k, s, t, ys, qv, qp);
      }
    }
  }
}

// Whether the window of the k-mer ending at base i has a unique minimum,
// from the canonical s-mers ys(e).
template <class Ys>
__device__ __forceinline__ bool window_unique(Ys&& ys, int i, int k, int s) {
  using S = smer_of<Ys>;
  const int w = k - s + 1;
  S m = ~S(0);
  int lm = 0, rm = 0;
  for (int e = i - w + 1; e <= i; ++e) {
    const S y = ys(e);
    if (y < m) {
      m = y;
      lm = e;
      rm = e;
    } else if (y == m) {
      rm = e;
    }
  }
  return lm == rm;
}

// The whole read's holder (its s-mer start) at the window of the k-mer
// ending at base c > k-1, a window whose minimum is tied; ys(e) reads the
// read's canonical s-mers.  The block looks back, blockDim.x windows at a
// time, for the last window before c whose minimum is unique (its holder
// is its argmin, whatever came before); then thread 0 replays the tracker
// from there, or from the read's first window where there is none,
// hopping from one slide-out to the next: every window after it up to c
// is tied, so no newcomer is strictly smaller.  found: a shared int.
// Every thread calls it; the holder is returned on thread 0.
template <class Ys>
__device__ int holder_at(Ys&& ys, int c, int k, int s, int t, int* found) {
  if (threadIdx.x == 0) *found = -1;
  __syncthreads();
  for (int top = c - 1; top >= k - 1; top -= blockDim.x) {
    const int e = top - (int)threadIdx.x;
    if (e >= k - 1 && window_unique(ys, e, k, s)) atomicMax(found, e);
    __syncthreads();
    const bool done = *found >= 0;
    __syncthreads();
    if (done) break;
  }
  int qp = 0;
  if (threadIdx.x == 0) {
    const int u = *found;
    smer_of<Ys> qv = 0;
    qp = u - k;  // as if the held minimum had just slid out of window u
    for (int i = u >= 0 ? u : k - 1;;) {
      tracker_step(i, k, s, t, ys, qv, qp);
      if (qp + k > c) break;
      i = qp + k;
    }
  }
  return qp;
}

}  // namespace taxor
