"""HyperLogLog cardinality sketch.

Replaces chopper's hyperloglog (used for per-genome k-mer counting and
union estimation at layout time, src/main/taxor_build.cpp:324-357,
389-423 and chopper's estimate_union/rearrangement).  Only layout sizing
depends on it, never classification output.

Standard HLL (Flajolet et al. 2007) with the small-range linear-counting
correction, vectorized over numpy.  Registers are indexed by the hash's
top ``bits`` bits; the rank is counted over the remaining bits.  Sketches
merge by register-wise max, which is what union estimation needs.
"""

from __future__ import annotations

import numpy as np


class HyperLogLog:
    __slots__ = ("bits", "m", "registers")

    def __init__(self, bits: int = 12, registers: np.ndarray | None = None):
        if not 4 <= bits <= 32:
            raise ValueError("bits must be in [4, 32]")
        self.bits = bits
        self.m = 1 << bits
        self.registers = (
            registers
            if registers is not None
            else np.zeros(self.m, dtype=np.uint8)
        )

    def add_many(self, hashes: np.ndarray) -> None:
        """Add uint64 hash values (already well-mixed, e.g. wyhash64)."""
        h = np.asarray(hashes, dtype=np.uint64)
        if h.size == 0:
            return
        idx = (h >> np.uint64(64 - self.bits)).astype(np.int64)
        rest = h << np.uint64(self.bits)
        # rank = leading zeros of remaining (64-bits) window + 1
        lz = np.full(h.shape, 64 - self.bits + 1, dtype=np.uint8)
        nz = rest != 0
        if nz.any():
            # leading zeros via float64 exponent would lose precision for
            # low bits; use a bit-length loop on the top 64-bit value
            r = rest[nz]
            count = np.zeros(r.shape, dtype=np.uint8)
            probe = np.uint64(1) << np.uint64(63)
            # binary search on leading zero count
            shift = 32
            cur = r.copy()
            while shift:
                mask_hi = cur >> np.uint64(64 - shift) == 0
                count[mask_hi] += shift
                cur[mask_hi] = cur[mask_hi] << np.uint64(shift)
                shift //= 2
            lz_nz = count + 1
            lz[nz] = np.minimum(lz_nz, 64 - self.bits + 1)
        np.maximum.at(self.registers, idx, lz)

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if other.bits != self.bits:
            raise ValueError("sketch width mismatch")
        return HyperLogLog(
            self.bits, np.maximum(self.registers, other.registers)
        )

    def estimate(self) -> float:
        m = float(self.m)
        alpha = 0.7213 / (1.0 + 1.079 / m)
        inv_sum = np.sum(2.0 ** -self.registers.astype(np.float64))
        e = alpha * m * m / inv_sum
        if e <= 2.5 * m:
            zeros = int((self.registers == 0).sum())
            if zeros:
                e = m * np.log(m / zeros)
        return float(e)


def union_estimate(a: HyperLogLog, b: HyperLogLog) -> float:
    return a.merge(b).estimate()
