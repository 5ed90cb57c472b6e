"""Hash-scheme dispatch shared by index build and search.

Mirrors the three call-site behaviors:
  - syncmer scheme: dedup set per sequence (search: taxor_search.cpp:219-238;
    build: compute_hashes.cpp:81-111),
  - minimizer / plain k-mer scheme: duplicates kept at search time
    (taxor_search.cpp:240-259), dedup set at build time,
  - optional FracMinHash scaling: keep hash h iff
    wyhash64(h) <= 2^64 / scaling, compared in double precision exactly like
    the reference (taxor_search.cpp:227-233: ``double(v) <=
    double(UINT64_MAX) / double(scaling)``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.u64np import wyhash64
from .encode import encode_dna4, encode_dna5
from .minimizer import minimiser_hashes
from .syncmer import syncmer_hashes_batch, t_syncmer_default

U64 = np.uint64


@dataclass(frozen=True)
class HashScheme:
    """Scheme parameters as stored in the index header
    (src/main/index.hpp:32-44)."""

    kmer_size: int = 20
    window_size: int = 20
    syncmer_size: int = 10
    t_syncmer: int = 6
    use_syncmer: bool = True
    scaling: int = 1

    @staticmethod
    def make(kmer_size: int, syncmer_size: int, window_size: int | None,
             use_syncmer: bool, scaling: int = 1) -> "HashScheme":
        if window_size is None or window_size < kmer_size:
            window_size = kmer_size
        return HashScheme(
            kmer_size=kmer_size,
            window_size=window_size,
            syncmer_size=syncmer_size,
            t_syncmer=t_syncmer_default(kmer_size, syncmer_size),
            use_syncmer=use_syncmer,
            scaling=scaling,
        )


def scaling_threshold_u64(scaling: int) -> int:
    """Largest uint64 T with float64(T) <= float64(UINT64_MAX)/scaling.

    The reference's FracMinHash keep-test is a DOUBLE comparison
    (taxor_search.cpp:229: ``double(v) <= double(UINT64_MAX)/double(
    scaling)``); double(v) is monotone in v, so the test is exactly
    ``v <= T`` for this integer threshold — which the device applies as
    a uint32-pair compare with no float math at all."""
    if scaling <= 1:
        return (1 << 64) - 1
    limit = np.float64(np.uint64(0xFFFFFFFFFFFFFFFF)) / np.float64(scaling)
    t = min(int(limit), (1 << 64) - 1)
    while t + 1 < (1 << 64) and np.float64(t + 1) <= limit:
        t += 1
    while t > 0 and np.float64(t) > limit:
        t -= 1
    return t


def scaling_filter(hashes: np.ndarray, scaling: int) -> np.ndarray:
    """FracMinHash downsampling with the reference's double-precision
    compare."""
    if scaling <= 1 or hashes.size == 0:
        return hashes
    v = wyhash64(hashes).astype(np.float64)
    limit = np.float64(0xFFFFFFFFFFFFFFFF) / np.float64(scaling)
    return hashes[v <= limit]


# Long sequences are split into segments for the batched scanner.  A
# segment is scanned with a 2k-base warm-up overlap: the scanner's state
# (rolling k-mer/s-mer values + the w-smer window minimum) depends only on
# the last k-1 + (w-1) < 2k bases since the previous N-reset, so emissions
# inside the segment body are bit-identical to a monolithic scan; overlap
# emissions duplicate and the per-sequence set dedup removes them.
SEG_LEN = 1 << 17
# cap on batch cells so the [rows, L] scan state stays in cache-friendly
# memory (rows * L * ~20 bytes of state/output)
CELL_BUDGET = 1 << 24


# host-thread fan-out for the native scanner (the reference's OpenMP /
# do_parallel analog); apps override this from --threads
NUM_THREADS = min(8, os.cpu_count() or 1)


def _syncmer_sets_native(seqs: list[bytes], scheme: HashScheme,
                         dna5: bool, lib) -> list[np.ndarray]:
    """Per-sequence native scan (C++ state machine), thread-parallel."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    k, s, t = scheme.kmer_size, scheme.syncmer_size, scheme.t_syncmer
    enc = encode_dna5 if dna5 else encode_dna4

    def scan_one(seq: bytes) -> np.ndarray:
        codes = np.ascontiguousarray(enc(seq))
        n = codes.shape[0]
        if n < k:
            return np.zeros(0, dtype=U64)
        out = np.empty(n, dtype=U64)
        cnt = lib.syncmer_scan(
            codes.ctypes.data_as(ctypes.c_void_p), n, k, s, t,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return np.unique(out[:cnt])

    if len(seqs) > 3 and NUM_THREADS > 1:
        with ThreadPoolExecutor(max_workers=NUM_THREADS) as ex:
            return list(ex.map(scan_one, seqs))
    return [scan_one(s_) for s_ in seqs]


def _syncmer_sets_batch(seqs: list[bytes], scheme: HashScheme,
                        dna5: bool) -> list[np.ndarray]:
    """Deduplicated syncmer hashes per sequence: native C++ scanner when
    available, else the vectorized numpy scan (segmenting long sequences
    and bucketing rows by length)."""
    if not seqs:
        return []
    from ..native import get_lib

    lib = get_lib()
    if lib is not None:
        return _syncmer_sets_native(seqs, scheme, dna5, lib)
    k, s, t = scheme.kmer_size, scheme.syncmer_size, scheme.t_syncmer
    enc = encode_dna5 if dna5 else encode_dna4
    overlap = 2 * k

    rows: list[np.ndarray] = []
    owner: list[int] = []
    for i, seq in enumerate(seqs):
        codes = enc(seq)
        n = codes.shape[0]
        if n <= SEG_LEN:
            rows.append(codes)
            owner.append(i)
        else:
            start = 0
            while start < n:
                end = min(n, start + SEG_LEN)
                rows.append(codes[max(0, start - overlap) : end])
                owner.append(i)
                start = end

    per_seq: list[list[np.ndarray]] = [[] for _ in seqs]
    # bucket rows by length (desc) so padding waste stays low
    order = sorted(range(len(rows)), key=lambda r: -rows[r].shape[0])
    pos = 0
    while pos < len(order):
        L = max(1, rows[order[pos]].shape[0])
        nrows = max(1, min(len(order) - pos, CELL_BUDGET // L))
        idxs = order[pos : pos + nrows]
        pos += nrows
        batch = np.full((len(idxs), L), 4, dtype=np.uint8)
        lengths = np.empty(len(idxs), dtype=np.int64)
        for j, r in enumerate(idxs):
            c = rows[r]
            batch[j, : c.shape[0]] = c
            lengths[j] = c.shape[0]
        h, v = syncmer_hashes_batch(batch, lengths, k, s, t)
        for j, r in enumerate(idxs):
            per_seq[owner[r]].append(h[j][v[j]])

    return [
        np.unique(np.concatenate(parts)) if parts else np.zeros(0, dtype=U64)
        for parts in per_seq
    ]


def search_hashes(seqs: list[bytes], scheme: HashScheme) -> list[np.ndarray]:
    """Per-read query hashes.  Reads come through dna4 (ambiguity -> A,
    taxor_search.cpp:181).  Syncmers are dedup'd; minimizer/k-mer hashes
    keep duplicates."""
    if scheme.use_syncmer:
        out = _syncmer_sets_batch(seqs, scheme, dna5=False)
    else:
        out = [
            minimiser_hashes(encode_dna4(s), scheme.kmer_size,
                             scheme.window_size)
            for s in seqs
        ]
    if scheme.scaling > 1:
        out = [scaling_filter(h, scheme.scaling) for h in out]
    return out


def build_hashes(record_seqs: list[bytes], scheme: HashScheme) -> np.ndarray:
    """Union hash set over the records of one reference genome (user bin),
    reproducing compute_hashes (src/hixf/build/compute_hashes.cpp:76-142)
    including the N-strip / trailing-base quirk (see encode.build_record_seq).
    Returns a sorted unique uint64 array."""
    from .encode import build_record_seq

    parts: list[np.ndarray] = []
    if scheme.use_syncmer:
        trimmed = [build_record_seq(s) for s in record_seqs]
        parts = _syncmer_sets_batch(trimmed, scheme, dna5=False)
    else:
        # minimizer path reads records directly (no N strip) through dna4
        for s in record_seqs:
            parts.append(
                minimiser_hashes(encode_dna4(s), scheme.kmer_size,
                                 scheme.window_size)
            )
    if parts:
        hashes = np.unique(np.concatenate(parts))
    else:
        hashes = np.zeros(0, dtype=U64)
    if scheme.scaling > 1:
        hashes = scaling_filter(hashes, scheme.scaling)
    return hashes


def count_hashes_for_sketch(record_seqs: list[bytes],
                            scheme: HashScheme) -> np.ndarray:
    """Hashes fed to the HLL cardinality sketch at layout time.

    The syncmer count path reads through dna5 (N resets the scanner,
    taxor_build.cpp:367,394-396) — unlike the index-hash path.  The
    minimizer count path in the reference hashes dna5 ranks (radix 5);
    we use the dna4 2-bit encoding instead (documented divergence — the
    sketch only drives layout sizing, never classification results).
    """
    parts: list[np.ndarray] = []
    if scheme.use_syncmer:
        parts = _syncmer_sets_batch(record_seqs, scheme, dna5=True)
    else:
        for s in record_seqs:
            parts.append(
                minimiser_hashes(encode_dna4(s), scheme.kmer_size,
                                 scheme.window_size)
            )
    if parts:
        hashes = np.concatenate(parts)
    else:
        hashes = np.zeros(0, dtype=U64)
    if scheme.scaling > 1:
        hashes = scaling_filter(hashes, scheme.scaling)
    return hashes
