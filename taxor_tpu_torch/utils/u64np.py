"""Exact 64-bit hash primitives on the host (numpy uint64).

These reproduce, bit for bit, the integer hash functions the reference
pipeline relies on:

  - wyhash64: ``ankerl::unordered_dense::detail::wyhash::hash(uint64_t)``
    (used as the canonical k-mer hash, reference
    src/hashing/syncmer.cpp:73-77, and as the FracMinHash scaling hash,
    src/main/taxor_search.cpp:227).  For a single uint64 key this is
    ``mix(x, 0x9E3779B97F4A7C15)`` where ``mix(a,b)`` folds the 128-bit
    product of a and b: ``lo(a*b) ^ hi(a*b)``.
  - murmur64 / SimpleMixSplit: the XOR-filter hash family
    (src/main/hashutil.hpp:50-61), ``murmur64(key + seed)``.
  - rotl64 / reduce32: probe-slot math of the XOR filter
    (src/main/xorfilter.hpp:22-45).

All functions are vectorized over numpy arrays and silence the uint64
overflow warnings (wrap-around is the point).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# wyhash secret for a single-word hash (golden-ratio constant).
_WYMIX_CONST = U64(0x9E3779B97F4A7C15)

# Fixed construction seed of the in-tree XOR filter reference
# (src/main/xorfilter.hpp:153).
XOR_SEED0 = 13572355802537770549

_M1 = U64(0xFF51AFD7ED558CCD)
_M2 = U64(0xC4CEB9FE1A85EC53)
_LO32 = U64(0xFFFFFFFF)


def _as_u64(x) -> np.ndarray:
    return np.asarray(x, dtype=U64)


def mul_hi_lo(a, b):
    """Full 128-bit product of two uint64 arrays -> (hi, lo) uint64 pair."""
    a = _as_u64(a)
    b = _as_u64(b)
    with np.errstate(over="ignore"):
        a_lo = a & _LO32
        a_hi = a >> U64(32)
        b_lo = b & _LO32
        b_hi = b >> U64(32)
        ll = a_lo * b_lo
        lh = a_lo * b_hi
        hl = a_hi * b_lo
        hh = a_hi * b_hi
        mid = (ll >> U64(32)) + (lh & _LO32) + (hl & _LO32)
        lo = (ll & _LO32) | ((mid & _LO32) << U64(32))
        hi = hh + (lh >> U64(32)) + (hl >> U64(32)) + (mid >> U64(32))
    return hi, lo


def wyhash64(x) -> np.ndarray:
    """ankerl unordered_dense wyhash of a uint64 key: lo(x*C) ^ hi(x*C)."""
    hi, lo = mul_hi_lo(x, _WYMIX_CONST)
    return hi ^ lo


def murmur64(h) -> np.ndarray:
    """murmur3 finalizer, the XOR-filter mix (src/main/hashutil.hpp:50-57)."""
    h = _as_u64(h)
    with np.errstate(over="ignore"):
        h = h ^ (h >> U64(33))
        h = h * _M1
        h = h ^ (h >> U64(33))
        h = h * _M2
        h = h ^ (h >> U64(33))
    return h


def mix_split(key, seed) -> np.ndarray:
    """SimpleMixSplit operator(): murmur64(key + seed) (hashutil.hpp:59-61)."""
    key = _as_u64(key)
    with np.errstate(over="ignore"):
        return murmur64(key + U64(seed))


def rotl64(x, c: int) -> np.ndarray:
    x = _as_u64(x)
    c = int(c) & 63
    if c == 0:
        return x.copy()
    with np.errstate(over="ignore"):
        return (x << U64(c)) | (x >> U64(64 - c))


def reduce32(r, n: int) -> np.ndarray:
    """Lemire fast range: (uint32(r) * n) >> 32 (xorfilter.hpp:36-39)."""
    r = _as_u64(r) & _LO32
    with np.errstate(over="ignore"):
        return (r * U64(n)) >> U64(32)


def probe_positions(hash64, block_length: int):
    """The 3 probe slots of a mixed hash.

    Query form (src/main/xorfilter.hpp:342-347):
      h_i = reduce(uint32(rotl64(hash, 21*i)), blockLength) + i*blockLength
    Returns an int64 array of shape hash.shape + (3,).
    """
    h = _as_u64(hash64)
    out = np.empty(h.shape + (3,), dtype=np.int64)
    for i in range(3):
        r = rotl64(h, 21 * i)
        out[..., i] = (reduce32(r, block_length) + U64(i * block_length)).astype(
            np.int64
        )
    return out


def fingerprint8(hash64) -> np.ndarray:
    """uint8 fingerprint: (FP)(hash ^ hash>>32) (xorfilter.hpp:60-62)."""
    h = _as_u64(hash64)
    return ((h ^ (h >> U64(32))) & U64(0xFF)).astype(np.uint8)
