"""Open canonical syncmer extraction on device tensors: host packing and
the plain PyTorch twin of the exact extraction.

Counterpart of ``taxor_tpu/hash/device_syncmer.py``.  The length
buckets, the hash capacity and the 2-bit packer are the JAX package's,
in numpy (``pack_reads`` keeps the native ``pack_reads_2bit`` call).
``syncmer_kmers`` -> ``dedup_kmers`` -> ``u64.wyhash64`` is the plain
twin of CUDA kernel K1 (``device/extract.py``): the same stateful
window-minimum tracker as the reference scanner (hash/syncmer.py,
src/hashing/syncmer.cpp:109-146), vectorised over reads and sequential
over base positions.

Search semantics are dna4: N and IUPAC codes pack as A and never reset
the scanner.  t is the reference's integer division (k - s + 1) // 2, and
the selection is strand-asymmetric (DIVERGENCES.md); both come from the
index's HashScheme.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.u64 import umin, usort_rows

# reads longer than this take the host-hash route (search/pipeline.py)
L_CAP = 32768

# sentinel for empty sort slots: all ones, which no canonical k-mer
# reaches (fwd == rev == all-T is impossible: rev(all-T) is all-A)
SENTINEL = -1


def supports(scheme) -> bool:
    """Whether the device extractor covers this hash scheme."""
    return (
        scheme.use_syncmer
        and scheme.scaling >= 1
        and 2 <= scheme.syncmer_size <= 15
        and scheme.syncmer_size < scheme.kmer_size <= 32
    )


def pad_len_bucket(max_len: int) -> int:
    """Power-of-two length bucket (>= 256)."""
    return max(256, 1 << (int(max_len) - 1).bit_length())


def hash_cap(L: int) -> int:
    """Per-read hash capacity for length bucket L.  Open-syncmer density
    is ~2/(k-s+1); reads denser than this fall back to the host oracle
    through the device-reported emission count."""
    return max(128, L // 4)


def pack_reads(seqs: list[bytes], L: int):
    """2-bit pack a read batch, 4 bases per byte.

    Returns (packed uint8 [R, L/4] with base i at bits 2*(i%4) of byte
    i//4, lengths int32 [R]).  dna4 semantics: A/a->0 C/c->1 G/g->2
    T/t/U/u->3, everything else (incl. N) -> A."""
    R = len(seqs)
    lengths = np.fromiter((min(len(s), L) for s in seqs), dtype=np.int64,
                          count=R)
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        packed = np.zeros((R, L // 4), dtype=np.uint8)
        ptrs = (ctypes.c_char_p * R)(*seqs)
        lib.pack_reads_2bit(
            ptrs, lengths.ctypes.data_as(ctypes.c_void_p), R, L,
            packed.ctypes.data_as(ctypes.c_void_p),
        )
        return packed, lengths.astype(np.int32)
    # numpy fallback (no compiler): branch-free u8 arithmetic
    buf = np.zeros((R, L), dtype=np.uint8)
    for r, s in enumerate(seqs):
        n = int(lengths[r])
        buf[r, :n] = np.frombuffer(s, dtype=np.uint8, count=n)
    upper = buf & np.uint8(0xDF)  # fold lowercase
    valid = (
        (upper == 65) | (upper == 67) | (upper == 71)
        | (upper == 84) | (upper == 85)
    )
    y = (buf >> np.uint8(1)) & np.uint8(3)
    code = (y ^ (y >> np.uint8(1))) & (valid * np.uint8(3))
    packed = (
        code[:, 0::4]
        | (code[:, 1::4] << np.uint8(2))
        | (code[:, 2::4] << np.uint8(4))
        | (code[:, 3::4] << np.uint8(6))
    )
    return packed, lengths.astype(np.int32)


def emission_min_gap(k: int, s: int, t: int) -> int:
    """Guaranteed minimum distance between consecutive open-syncmer
    emissions, any input: min(t, w-t+1) for 2 <= t <= w-1, else 1
    (proof in taxor_tpu/hash/device_syncmer.emission_min_gap)."""
    w = k - s + 1
    if t < 2 or t > w - 1:
        return 1
    return min(t, w - t + 1)


def max_emissions(L: int, k: int, s: int, t: int) -> int:
    """Upper bound on the emissions of one read of at most L bases."""
    if L < k:
        return 0
    return (L - k) // emission_min_gap(k, s, t) + 1


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, L/4] (pack_reads layout) -> int64 base codes [R, L]."""
    p = packed.to(torch.int64)
    shifts = torch.arange(0, 8, 2, device=packed.device)
    return ((p[:, :, None] >> shifts) & 3).reshape(p.shape[0], -1)


def _shift_right(x: torch.Tensor, d: int, fill: int = 0) -> torch.Tensor:
    """y[:, i] = x[:, i - d] (fill for i < d)."""
    if d == 0:
        return x
    pad = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :-d]], dim=1)


def _rolling(codes: torch.Tensor, m: int):
    """(fwd, rev) raw 2-bit values of the m-mer ending at each position
    (junk for i < m-1), exactly the reference's rolling registers:
    fwd = x<<2 | c (newest base lowest), rev = x>>2 | (3-c)<<2(m-1)."""
    fwd = torch.zeros_like(codes)
    rev = torch.zeros_like(codes)
    for j in range(m):
        c = _shift_right(codes, j)
        fwd = fwd | (c << (2 * j))
        rev = rev | ((3 - c) << (2 * (m - 1 - j)))
    return fwd, rev


def syncmer_kmers(packed: torch.Tensor, lengths: torch.Tensor, k: int,
                  s: int, t: int):
    """Canonical k-mer and emission mask per END position.

    Returns (kmer int64 [R, L] canonical k-mer bit patterns, emit bool
    [R, L]): emit[r, i] marks an open-syncmer k-mer ending at base i.
    The window-minimum tracker is the reference's: leftmost minimum on
    the first full window; when the held minimum slides out, the
    RIGHTMOST minimum of the new window; otherwise only a strictly
    smaller newcomer takes over."""
    w = k - s + 1
    codes = unpack_codes(packed)
    R, L = codes.shape
    dev = codes.device
    emit = torch.zeros((R, L), dtype=torch.bool, device=dev)
    sf, sr = _rolling(codes, s)
    ys = torch.minimum(sf, sr)  # s <= 15: no sign bit involved
    kf, kr = _rolling(codes, k)
    kmer = umin(kf, kr)
    if L < k:
        return kmer, emit
    # rightmost minimum of the w s-mers ending at i-w+1 .. i: scanning
    # leftwards, only a strictly smaller value moves the holder
    ends = torch.arange(L, device=dev).expand(R, L)
    rm_val, rm_end = ys, ends
    for d in range(1, w):
        cand = _shift_right(ys, d, fill=1 << 62)
        take = cand < rm_val
        rm_val = torch.where(take, cand, rm_val)
        rm_end = torch.where(take, ends - d, rm_end)
    # first full window (k-mer ends at k-1): leftmost minimum, strict <
    qv = ys[:, s - 1].clone()
    qp = torch.zeros(R, dtype=torch.int64, device=dev)
    for j in range(1, w):
        col = ys[:, s - 1 + j]
        take = col < qv
        qv = torch.where(take, col, qv)
        qp = torch.where(take, torch.full_like(qp, j), qp)
    emit[:, k - 1] = qp == t - 1
    ys_t, rv_t, re_t = ys.t(), rm_val.t(), rm_end.t()
    for i in range(k, L):
        popped = qp == i - k
        newer = ~popped & (ys_t[i] < qv)
        qv = torch.where(popped, rv_t[i], torch.where(newer, ys_t[i], qv))
        qp = torch.where(popped, re_t[i] - (s - 1),
                         torch.where(newer, torch.full_like(qp, i - s + 1),
                                     qp))
        emit[:, i] = qp == i - k + t
    pos = torch.arange(L, device=dev)[None, :]
    return kmer, emit & (pos < lengths.to(torch.int64)[:, None])


def dedup_kmers(kmer: torch.Tensor, emit: torch.Tensor, hcap: int,
                sort_rows=usort_rows):
    """Sort each read's emitted canonical k-mers, mark first occurrences,
    keep the first hcap sorted slots.

    Returns (kmer int64 [R, hcap] ascending as uint64 with SENTINEL past
    the emissions, valid bool [R, hcap], n_unique int32 [R] over ALL
    emissions, n_emit int32 [R] pre-dedup).  n_emit > hcap means unique
    k-mers may lie beyond the slice: the caller falls back to the host
    oracle for that read.

    sort_rows sorts the sentinel-masked rows ascending as uint64: the
    plain ``torch.sort`` by default (the plain twin); device/sort.py's
    ``dedup_pairs`` passes the pair sort K4."""
    R, L = kmer.shape
    n_emit = emit.sum(dim=1)
    srt = sort_rows(torch.where(emit, kmer, torch.full_like(kmer, SENTINEL)))
    prev = torch.cat([srt[:, :1] ^ 1, srt[:, :-1]], dim=1)
    uniq = (srt != prev) & (srt != SENTINEL)
    n_unique = uniq.sum(dim=1)
    if L < hcap:
        srt = torch.cat([srt, torch.full((R, hcap - L), SENTINEL,
                                         dtype=srt.dtype,
                                         device=srt.device)], dim=1)
        uniq = torch.cat([uniq, torch.zeros((R, hcap - L), dtype=torch.bool,
                                            device=uniq.device)], dim=1)
    return (srt[:, :hcap], uniq[:, :hcap], n_unique.to(torch.int32),
            n_emit.to(torch.int32))
