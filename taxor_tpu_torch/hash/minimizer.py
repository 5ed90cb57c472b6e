"""seqan3-compatible minimiser / plain k-mer hashing.

The reference's non-syncmer path is ``seqan3::views::minimiser_hash(shape,
window_size, seed)`` with ``seed = adjust_seed(k) = 0x8F3F73B5CF1C9ADE >>
(64 - 2k)`` (src/hixf/build/adjust_seed.hpp:40-44; call sites
src/main/taxor_search.cpp:210-212, src/hixf/build/compute_hashes.cpp:120-124).

Semantics reproduced here:

  - per position p the *canonical* value is
        min(packed_fwd(kmer_p) ^ seed, packed_rc(kmer_p) ^ seed)
    where packed_* is the 2-bit rank encoding (A0 C1 G2 T3) and rc is the
    reverse complement of the same k-mer window,
  - a sliding window of w' = window_size - k + 1 canonical values with
    seqan3's minimiser emission rule: the first window emits its leftmost
    minimum; afterwards a window emits only when (a) the previous minimiser
    slid out (recompute leftmost minimum — emits even if the value repeats)
    or (b) the new value is strictly smaller than the current minimiser
    (computed here as the changes of each window's leftmost argmin, which
    is the same rule: ``minimiser_emissions``),
  - with window_size == k (the default: build_arguments.hpp:18) every
    position emits, i.e. the plain canonical k-mer path.

Duplicate policy mirrors the call sites: index construction inserts into a
hash set; search pushes into a vector (duplicates kept,
taxor_search.cpp:242-259).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64
SEED64 = 0x8F3F73B5CF1C9ADE


def adjust_seed(k: int, seed: int = SEED64) -> int:
    return seed >> (64 - 2 * k)


def canonical_kmer_values(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 [n-k+1] canonical (min of fwd/rc) XOR-seeded k-mer values of a
    single sequence with codes in {0..3}. Vectorized via sliding windows."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if n < k:
        return np.zeros(0, dtype=U64)
    seed = U64(adjust_seed(k))
    c = codes.astype(U64)
    fwd = np.zeros(n - k + 1, dtype=U64)
    rev = np.zeros(n - k + 1, dtype=U64)
    with np.errstate(over="ignore"):
        for j in range(k):
            fwd = (fwd << U64(2)) | c[j : n - k + 1 + j]
            # rc: complement of base at mirrored offset
            rev = (rev << U64(2)) | (U64(3) - c[k - 1 - j : n - j])
    return np.minimum(fwd ^ seed, rev ^ seed)


# windows a chunk of minimiser_emissions scans at once (its [chunk, w']
# window view bounds the memory of argmin's buffer)
_WINDOW_CHUNK = 1 << 20


def minimiser_emissions(values: np.ndarray, wprime: int) -> np.ndarray:
    """Apply seqan3's minimiser emission rule over windows of `wprime`
    canonical values. Returns emitted values in order (duplicates kept).

    The rule's holder is always the LEFTMOST minimum of the current
    window: the first window takes its leftmost minimum; a strictly
    smaller newcomer is the window's only minimum; a holder that slides
    out is replaced by the leftmost minimum; and ties never displace the
    holder, which is then the leftmost of them.  A value is emitted
    exactly when that position changes (and for the first window), so
    the scan is a vectorised leftmost argmin over every window (numpy's
    argmin returns the first occurrence), in chunks."""
    n = values.shape[0]
    if n < wprime:
        return np.zeros(0, dtype=U64)
    if wprime == 1:
        return values.copy()
    win = np.lib.stride_tricks.sliding_window_view(values, wprime)
    # each window's leftmost argmin, as a position in values
    pos = np.concatenate([
        win[a:a + _WINDOW_CHUNK].argmin(axis=1)
        for a in range(0, win.shape[0], _WINDOW_CHUNK)])
    pos += np.arange(pos.shape[0])
    change = np.ones(pos.shape[0], dtype=bool)
    change[1:] = pos[1:] != pos[:-1]
    return values[pos[change]]


def minimiser_hashes(codes: np.ndarray, k: int, window: int) -> np.ndarray:
    """Emitted minimiser hash values for one dna4-coded sequence."""
    vals = canonical_kmer_values(codes, k)
    return minimiser_emissions(vals, window - k + 1)
