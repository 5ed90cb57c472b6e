"""64-bit hash math on torch int64 tensors holding uint64 bit patterns.

Counterpart of ``taxor_tpu/utils/u64jnp.py``.  The TPU had no 64-bit
integers, so the JAX package carries (hi, lo) uint32 pairs.  Torch has
int64 everywhere, but its CPU build implements neither ``>>``, ``<`` nor
``+`` for uint64, so every value here is the int64 with the same bits:

  - add and multiply wrap modulo 2^64, which is uint64 arithmetic;
  - a logical right shift is an arithmetic shift plus a mask (``srl``);
  - an unsigned compare flips the sign bit first (``ult``);
  - the 64x64 -> 128 product goes through 32-bit limbs (``umul64_full``).

Bit-exact against ``taxor_tpu/utils/u64np.py`` (tests/test_torch_u64.py).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
INT64_MIN = -(1 << 63)


def i64(c: int) -> int:
    """The int64 with the bits of the uint64 ``c``."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >= 1 << 63 else c


_M1 = i64(0xFF51AFD7ED558CCD)
_M2 = i64(0xC4CEB9FE1A85EC53)
_WY = i64(0x9E3779B97F4A7C15)


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift by a static amount 0 <= s < 64."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotl64(x: torch.Tensor, s: int) -> torch.Tensor:
    s %= 64
    if s == 0:
        return x
    return (x << s) | srl(x, 64 - s)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b."""
    return (a ^ INT64_MIN) < (b ^ INT64_MIN)


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(ult(b, a), b, a)


def usort_rows(x: torch.Tensor) -> torch.Tensor:
    """The rows of x sorted as uint64 (torch.sort is signed: flip the
    sign bit on the way in and out)."""
    return torch.sort(x ^ INT64_MIN, dim=1).values ^ INT64_MIN


def join32(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """int64 from (hi, lo) 32-bit halves given as int32 bit patterns."""
    return (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & MASK32)


def split32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int32 bit patterns of an int64 tensor."""
    hi = srl(x, 32)
    lo = x & MASK32
    # int64 -> int32 keeps the low 32 bits
    return hi.to(torch.int32), lo.to(torch.int32)


def umul64_full(a: torch.Tensor, b) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 64-bit halves of the full 128-bit product a * b.  Each
    32x32 limb product wraps into int64 with exactly the uint64 bits."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(i64(b), dtype=torch.int64, device=a.device)
    a_lo, a_hi = a & MASK32, srl(a, 32)
    b_lo, b_hi = b & MASK32, srl(b, 32)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    mid = srl(ll, 32) + (lh & MASK32) + (hl & MASK32)  # < 3 * 2^32
    lo = (ll & MASK32) | ((mid & MASK32) << 32)
    hi = hh + srl(lh, 32) + srl(hl, 32) + srl(mid, 32)
    return hi, lo


def murmur64(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer (utils/u64np.murmur64)."""
    h = h ^ srl(h, 33)
    h = h * _M1
    h = h ^ srl(h, 33)
    h = h * _M2
    return h ^ srl(h, 33)


def mix_split(key: torch.Tensor, seed: int) -> torch.Tensor:
    """murmur64(key + seed) — the XOR-filter hash family."""
    return murmur64(key + i64(seed))


def wyhash64(x: torch.Tensor) -> torch.Tensor:
    """ankerl unordered_dense wyhash of a uint64 key: hi(x*C) ^ lo(x*C)
    (the canonical k-mer hash, utils/u64np.wyhash64)."""
    hi, lo = umul64_full(x, _WY)
    return hi ^ lo


def reduce32(r: torch.Tensor, n: int) -> torch.Tensor:
    """Lemire fast range: (uint32(r) * n) >> 32, n < 2^32."""
    return srl((r & MASK32) * int(n), 32)


def probe_positions_and_fprint4(h: torch.Tensor, seed: int,
                                block_length: int):
    """Counterpart of ixf.compute_probes + fingerprint packing on key
    tensors: (pos int32 [..., 3], f4 int32 with the uint8 fingerprint
    replicated into all 4 bytes)."""
    m = mix_split(h, seed)
    bl = int(block_length)
    pos = torch.stack(
        [reduce32(rotl64(m, 21 * i), bl) + i * bl for i in range(3)],
        dim=-1).to(torch.int32)
    f = (m ^ srl(m, 32)) & 0xFF
    return pos, (f * 0x01010101).to(torch.int32)
