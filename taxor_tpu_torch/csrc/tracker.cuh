// The reference's open-canonical-syncmer tracker over one read, run by
// ONE thread: shared by K1 (extract.cu, syncmer_extract) and the split
// engine's syncmer_track (extract.cu).
//
// The exact stateful window-minimum tracker of hash/syncmer.py and
// src/hashing/syncmer.cpp:109-146: leftmost minimum on the first full
// window; when the held minimum slides out, the RIGHTMOST minimum of the
// new window; otherwise only a strictly smaller newcomer takes over.  Its
// state depends on history (tied minima), so it is sequential: ~30
// dependent instructions per base.
#pragma once
#include <cstdint>

namespace taxor {

// Base i of a read staged as 2-bit words: bits 2*(i%16) of word i/16
// (the pack_reads layout read as uint32).
__device__ __forceinline__ uint32_t base_at(const uint32_t* words, int i) {
  return (words[i >> 4] >> (2 * (i & 15))) & 3u;
}

// Runs the tracker over bases [0, len) of `words` and calls
// emit(n, i, kmer) for the n-th emission, the canonical k-mer ending at
// base i.  `ring` is 32 words of scratch (w = k-s+1 <= 31 s-mer ends stay
// live).  Returns the number of emissions.  2 <= s <= 15, s < k <= 32,
// 1 <= t <= k-s+1.
template <class Emit>
__device__ int track_syncmers(const uint32_t* words, uint32_t* ring, int len,
                              int k, int s, int t, Emit&& emit) {
  const int w = k - s + 1;
  const uint64_t kmask = k == 32 ? ~0ull : ((1ull << (2 * k)) - 1);
  const uint32_t smask = (1u << (2 * s)) - 1;
  const int kshift = 2 * (k - 1), sshift = 2 * (s - 1);
  uint64_t xk0 = 0, xk1 = 0;
  uint32_t xs0 = 0, xs1 = 0, word = 0;
  uint32_t qv = 0xFFFFFFFFu;  // held minimum value ...
  int qp = -1;                // ... and its s-mer start
  int n = 0;
  for (int i = 0; i < len; ++i) {
    if ((i & 15) == 0) word = words[i >> 4];
    const uint32_t c = (word >> (2 * (i & 15))) & 3u;
    xk0 = ((xk0 << 2) | c) & kmask;
    xk1 = (xk1 >> 2) | ((uint64_t)(3u - c) << kshift);
    xs0 = ((xs0 << 2) | c) & smask;
    xs1 = (xs1 >> 2) | ((3u - c) << sshift);
    if (i < s - 1) continue;
    const uint32_t ys = min(xs0, xs1);
    ring[i & 31] = ys;  // s-mer ending at i
    if (i < k - 1) continue;
    if (i == k - 1) {  // first full window: leftmost minimum
      qv = 0xFFFFFFFFu;
      for (int j = 0; j < w; ++j) {
        const uint32_t v = ring[(s - 1 + j) & 31];
        if (v < qv) {
          qv = v;
          qp = j;
        }
      }
    } else if (qp == i - k) {  // the minimum slid out: rightmost minimum
      qv = 0xFFFFFFFFu;
      for (int j = w - 1; j >= 0; --j) {
        const uint32_t v = ring[(i - w + 1 + j) & 31];
        if (v < qv) {
          qv = v;
          qp = i - k + 1 + j;
        }
      }
    } else if (ys < qv) {  // only a strictly smaller newcomer takes over
      qv = ys;
      qp = i - s + 1;
    }
    if (qp == i - k + t) {
      emit(n, i, xk0 < xk1 ? xk0 : xk1);
      ++n;
    }
  }
  return n;
}

}  // namespace taxor
