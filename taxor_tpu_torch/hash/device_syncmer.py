"""Open canonical syncmer extraction on device tensors: host packing and
the plain PyTorch twin of the exact extraction.

Counterpart of ``taxor_tpu/hash/device_syncmer.py``.  The length
buckets and the 2-bit packer are the JAX package's, in numpy
(``pack_reads`` keeps the native ``pack_reads_2bit`` call); the hash
capacity is the JAX package's at k - s + 1 >= 8 and wider below it
(``hash_cap``).  ``syncmer_kmers`` -> ``dedup_kmers`` ->
``u64.wyhash64`` is the plain twin of CUDA kernel K1
(``device/extract.py``; of both its instances, 32-bit s-mers up to s =
15 and 64-bit ones up to s = 31: the twin computes in int64 for every
s): the same stateful window-minimum tracker as the reference scanner
(hash/syncmer.py, src/hashing/syncmer.cpp:109-146), vectorised over
reads and positions as K1 computes it (``syncmer_emissions``), the tied
runs replayed one step at a time.  A read longer than L_CAP runs in
pieces (``piece_count``, ``bucket_len``, ``piece_owned``;
``syncmer_kmers_pieces`` is the twin of K1's piece rows).

Search semantics are dna4: N and IUPAC codes pack as A and never reset
the scanner.  t is the reference's integer division (k - s + 1) // 2, and
the selection is strand-asymmetric (DIVERGENCES.md); both come from the
index's HashScheme.

``minimizer_kmers_plain`` is the plain twin of CUDA kernel K5
(``device/extract.minimizer_kmers``): the minimiser and plain k-mer
scheme, whose emission is a pure function of each position (see its
docstring), so it needs no tracker and takes a row of any length.  A
minimiser or plain k-mer read past L_CAP is not cut: it runs whole in
the bucket ``bucket_len`` gives it, the span of a power-of-two count of
pieces (a multiple of 16 bases, as K5 needs), so that one length bucket
serves every scheme.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.u64 import INT64_MIN, i64, split32, umin, usort_rows
from .minimizer import adjust_seed

# the longest row K1 stages whole in a block's shared memory (148 KB of
# its 227 at k = 22, s = 12); a syncmer read longer than this is cut into
# pieces of L_CAP bases, PIECE_STRIDE apart, each a row of K1
# (device/extract.py), whose hashes device/sort.union_pieces joins.  It
# bounds K1's rows only: K5 (minimisers, plain k-mers) takes the longer
# buckets whole
L_CAP = 32768
# bases a piece shares with the next: at least k - 1, so that the piece
# holds the k-mers of every window it owns; a multiple of 16 keeps the
# pieces on whole packed words
PIECE_OVERLAP = 32
PIECE_STRIDE = L_CAP - PIECE_OVERLAP

# sentinel for empty sort slots: all ones, which no canonical k-mer
# reaches (fwd == rev == all-T is impossible: rev(all-T) is all-A)
SENTINEL = -1


def supports(scheme) -> bool:
    """Whether the device extractor covers this hash scheme: K1 takes
    2 <= s < k <= 32, 32-bit canonical s-mers for s <= 15 and 64-bit ones
    up to s = 31 (device/extract.smer_bits), so every syncmer scheme the
    CLI builds (k <= 30)."""
    return (
        scheme.use_syncmer
        and scheme.scaling >= 1
        and 2 <= scheme.syncmer_size <= 31
        and scheme.syncmer_size < scheme.kmer_size <= 32
    )


def supports_minimizer(scheme) -> bool:
    """Whether the device minimiser / plain k-mer extractor (K5) covers
    this hash scheme."""
    return (
        not scheme.use_syncmer
        and scheme.scaling >= 1
        and 2 <= scheme.kmer_size <= 32
        and scheme.window_size >= scheme.kmer_size
    )


def pad_len_bucket(max_len: int) -> int:
    """Power-of-two length bucket (>= 256)."""
    return max(256, 1 << (int(max_len) - 1).bit_length())


def piece_count(n: int) -> int:
    """The pieces of a read of n bases: 1 up to L_CAP, else enough rows of
    L_CAP bases PIECE_STRIDE apart to reach its last base."""
    if n <= L_CAP:
        return 1
    return 1 + -(-(n - L_CAP) // PIECE_STRIDE)


def pieces_len(P: int) -> int:
    """Bases spanned by P pieces: the row length of a bucket of P pieces
    (L_CAP for one)."""
    return (P - 1) * PIECE_STRIDE + L_CAP


def bucket_pieces(L: int) -> int:
    """The pieces of each read of length bucket L (1 up to L_CAP)."""
    if L <= L_CAP:
        return 1
    P = (L - L_CAP) // PIECE_STRIDE + 1
    if pieces_len(P) != L or P & (P - 1):
        raise ValueError(f"{L} bases is no bucket of pieces")
    return P


def bucket_len(n: int) -> int:
    """The length bucket of a read of n bases: a power of two (>= 256) up
    to L_CAP, past it the span of a power-of-two count of pieces, so that
    shapes stay bounded (a multiple of 16 bases: the rows of K1's pieces
    for a syncmer read, K5's whole row for a minimiser or plain k-mer
    read)."""
    if n <= L_CAP:
        return pad_len_bucket(n)
    return pieces_len(1 << (piece_count(n) - 1).bit_length())


def hash_cap(L: int, k: int, s: int, t: int) -> int:
    """Per-read hash capacity of scheme (k, s, t) for length bucket L: the
    sorted hash slots K1 keeps of a read (or of a piece).  Open-syncmer
    density is ~1/(k-s+1) (on random 4,000-base reads the plain twin
    emits ~350 a read at k = 22, s = 12 and ~1,390 at k = 16, s = 14), so
    a row of Lp = min(L, L_CAP) positions takes

        max(128, Lp / 4, min(sort_width(Lp), 128 * ceil(2 Lp / (128 w))))

    slots, w = k - s + 1: twice the density, the JAX package's margin for
    errors and repeats, in whole 128-slot lanes, never past K1's sort
    buffer; at w >= 8 that is the L/4 of the JAX package's static shape
    (taxor_tpu/hash/device_syncmer.hash_cap), which every such scheme
    keeps, and narrower schemes get more (k = 16, s = 14: 2,816 at L =
    4,096 against 1,024).  A bucket of P pieces has P x L_CAP positions,
    P x hash_cap(L_CAP) slots (the pieces' slots side by side).  Reads
    that emit more than this fall back to the host oracle through the
    device-reported emission count."""
    P = bucket_pieces(L)
    Lp = min(L, L_CAP)
    dense = 128 * -(-2 * Lp // (128 * (k - s + 1)))
    return P * max(128, Lp // 4, min(sort_width(Lp, k, s, t), dense))


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


def sort_width(L: int, k: int, s: int, t: int) -> int:
    """Power-of-two width of K1's sort buffer: covers every possible
    emission of a row of L bases."""
    return 1 << max(0, max_emissions(L, k, s, t) - 1).bit_length()


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [R, L/4] (pack_reads layout) -> int64 base codes [R, L]."""
    p = packed.to(torch.int64)
    shifts = torch.arange(0, 8, 2, device=packed.device)
    return ((p[:, :, None] >> shifts) & 3).reshape(p.shape[0], -1)


def _shift_right(x: torch.Tensor, d: int, fill: int = 0) -> torch.Tensor:
    """y[:, i] = x[:, i - d] (fill for i < d)."""
    if d == 0:
        return x
    d = min(d, x.shape[1])  # a shift past the row leaves only fill
    pad = torch.full((x.shape[0], d), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:, :x.shape[1] - d]], dim=1)


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
    [R, L]): emit[r, i] marks an open-syncmer k-mer ending at base i."""
    codes = unpack_codes(packed)
    kf, kr = _rolling(codes, k)
    return umin(kf, kr), syncmer_emissions(codes, lengths, k, s, t)


def syncmer_emissions(codes: torch.Tensor, lengths: torch.Tensor, k: int,
                      s: int, t: int) -> torch.Tensor:
    """bool [R, L]: the open-syncmer emissions of base codes [R, L]
    (unpack_codes) by the reference's stateful window-minimum tracker:
    leftmost minimum on the first full window; when the held minimum
    slides out, the RIGHTMOST minimum of the new window; otherwise only a
    strictly smaller newcomer takes over; emit the k-mer ending at i iff
    the held s-mer starts at i-k+t.

    Computed as K1 computes it (csrc/tracker.cuh): the held value is
    always the window minimum, so a window whose minimum is unique emits
    iff its argmin is at the offset, whatever came before; a tied window
    with no minimum at the offset emits nothing; the tied runs that hold
    one are replayed with the tracker's rule from the unique window
    before them (``_replay``)."""
    w = k - s + 1
    R, L = codes.shape
    dev = codes.device
    if L < k:
        return torch.zeros((R, L), dtype=torch.bool, device=dev)
    sf, sr = _rolling(codes, s)
    ys = torch.minimum(sf, sr)  # s <= 31: below 2^62, no sign bit involved
    ends = torch.arange(L, device=dev).expand(R, L)
    # the minimum of ys[i-w+1 .. i] and its leftmost and rightmost argmin,
    # from the oldest s-mer to the newest
    big = 1 << 62
    m = torch.full((R, L), big, dtype=ys.dtype, device=dev)
    lm = torch.zeros_like(ends)
    rm = torch.zeros_like(ends)
    for d in range(w - 1, -1, -1):
        cand = _shift_right(ys, d, fill=big)
        lt, le = cand < m, cand <= m
        lm = torch.where(lt, ends - d, lm)
        rm = torch.where(le, ends - d, rm)
        m = torch.where(lt, cand, m)
    live = (ends >= k - 1) & (ends < lengths.to(torch.int64)[:, None])
    tied = (lm != rm) & live
    emit = ~tied & live & (lm == ends - w + t)
    uncertain = tied & (_shift_right(ys, w - t) == m)
    rows = torch.nonzero(uncertain.any(dim=1)).flatten().tolist()
    if rows:
        ys_h, tied_h, unc_h = (x.cpu().numpy() for x in (ys, tied, uncertain))
        emit_h = emit.cpu().numpy()
        for r in rows:
            _replay(ys_h[r], tied_h[r], unc_h[r], emit_h[r], k, s, t)
        emit = torch.from_numpy(emit_h).to(dev)
    return emit


def _tracker_step(ys, i: int, k: int, s: int, t: int, qv: int, qp: int):
    """The reference tracker at the window of the k-mer ending at i over
    the canonical s-mers ys (by end base): (qv, qp, emitted)."""
    w = k - s + 1
    if i == k - 1:  # first full window: leftmost minimum
        j = int(np.argmin(ys[s - 1:s - 1 + w]))
        qp, qv = j, int(ys[s - 1 + j])
    elif qp == i - k:  # slid out: rightmost minimum
        seg = ys[i - w + 1:i + 1]
        j = w - 1 - int(np.argmin(seg[::-1]))
        qp, qv = i - k + 1 + j, int(seg[j])
    elif ys[i] < qv:  # a strictly smaller newcomer
        qp, qv = i - s + 1, int(ys[i])
    return qv, qp, qp == i - k + t


def _replay(ys, tied, uncertain, emit, k: int, s: int, t: int) -> None:
    """Marks in emit (numpy bool [L], in place) the emissions of every
    maximal run of tied windows that holds an uncertain one, replaying the
    tracker from the unique window before the run (a holder that has just
    slid out rescans it, and its rightmost minimum is its only one) or
    from the first window, up to the run's last uncertain window.  Inside
    a tied run no newcomer is strictly smaller than the held minimum, so
    the holder changes only where it slides out: the replay hops there
    and marks the one window in between where the holder sits at the
    offset (tracker.cuh resolve_tied_runs)."""
    idx = np.flatnonzero(tied)
    cut = np.flatnonzero(np.diff(idx) != 1)
    starts = np.concatenate([idx[:1], idx[cut + 1]])
    stops = np.concatenate([idx[cut], idx[-1:]])
    unc = np.flatnonzero(uncertain)
    for a, b in zip(starts.tolist(), stops.tolist()):
        j = int(np.searchsorted(unc, b, side="right")) - 1
        if j < 0 or unc[j] < a:
            continue
        last = int(unc[j])
        qv, qp = 0, a - 1 - k
        i = a if a == k - 1 else a - 1
        while i <= last:
            qv, qp, hit = _tracker_step(ys, i, k, s, t, qv, qp)
            if hit:
                emit[i] = True
            e = qp + k - t  # the window where the holder emits
            if i < e <= last:
                emit[e] = True
            i = qp + k


def piece_rows(packed: torch.Tensor, P: int) -> torch.Tensor:
    """uint8 [R * P, L_CAP / 4]: the P pieces of each packed read [R,
    pieces_len(P) / 4], piece j of read r in row r * P + j."""
    R = packed.shape[0]
    idx = (torch.arange(P, device=packed.device)[:, None]
           * (PIECE_STRIDE // 4)
           + torch.arange(L_CAP // 4, device=packed.device)[None, :])
    return packed[:, idx].reshape(R * P, L_CAP // 4)


def piece_owned(lengths: torch.Tensor, P: int, k: int) -> torch.Tensor:
    """bool [R * P, L_CAP]: the windows (k-mer ends, row positions) each
    piece owns.  Piece j of a read of n bases exists where j <
    piece_count(n); it owns [k-1, PIECE_STRIDE + k - 1) where a piece
    follows (the next owns the windows from its first on), else its
    windows up to the read's end, so the pieces' owned windows partition
    the read's."""
    n = lengths.to(torch.int64)[:, None]
    dev = lengths.device
    j = torch.arange(P, device=dev)[None, :]
    pieces = torch.where(n <= L_CAP, 1,
                         1 + torch.div(n - L_CAP + PIECE_STRIDE - 1,
                                       PIECE_STRIDE, rounding_mode="floor"))
    ln = torch.where(j < pieces, (n - j * PIECE_STRIDE).clamp(0, L_CAP), 0)
    own = torch.where(j < pieces - 1, PIECE_STRIDE + k - 1, ln)
    pos = torch.arange(L_CAP, device=dev)
    owned = (pos >= k - 1) & (pos < own[:, :, None])
    return owned.reshape(-1, L_CAP)


def syncmer_kmers_pieces(packed: torch.Tensor, lengths: torch.Tensor,
                         k: int, s: int, t: int, P: int):
    """``syncmer_kmers`` of each read's P pieces (packed [R,
    pieces_len(P) / 4], lengths the whole reads'): (kmer int64 [R * P,
    L_CAP] of each piece's own row, bases before it read as A; emit bool
    [R * P, L_CAP], the whole read's emissions in the windows the piece
    owns).  The plain twin of K1's and syncmer_track's piece rows."""
    R = packed.shape[0]
    emit_read = syncmer_emissions(unpack_codes(packed), lengths, k, s, t)
    idx = (torch.arange(P, device=packed.device)[:, None] * PIECE_STRIDE
           + torch.arange(L_CAP, device=packed.device)[None, :])
    emit = emit_read[:, idx].reshape(R * P, L_CAP) & piece_owned(
        lengths, P, k)
    kf, kr = _rolling(unpack_codes(piece_rows(packed, P)), k)
    return umin(kf, kr), emit


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


def minimizer_kmers_plain(packed: torch.Tensor, lengths: torch.Tensor,
                          k: int, window: int):
    """Minimiser (plain k-mer where window == k) emissions per END
    position: the plain twin of K5, counterpart of the JAX
    ``minimizer_kmers``.

    Returns (hi, lo int32 [R, L] bit patterns of the emitted value, 0
    where nothing is emitted; emit bool [R, L]; n_emit int32 [R]).  The
    value of position i is the reference's canonical XOR-seeded packing
    min(fwd ^ seed, rc ^ seed), seed = adjust_seed(k)
    (hash/minimizer.py), compared as uint64; the reference probes it
    directly (no wyhash) and keeps duplicates (vector semantics).

    The holder of seqan3's minimiser rule is always the LEFTMOST minimum
    of the window of w' = window - k + 1 values ending at i (a strictly
    smaller newcomer is the window's only minimum; ties keep the older,
    more-left holder; a holder that slides out is replaced by the
    leftmost minimum), so with argmin(i) that position,

        emit[i] = i < length and (i == k + w' - 2
                  or (i > k + w' - 2 and argmin(i) != argmin(i - 1)))

    and the emitted value is the window minimum.  w' = 1 emits every
    position from k - 1 on."""
    wp = window - k + 1
    codes = unpack_codes(packed)
    R, L = codes.shape
    dev = codes.device
    fwd, rev = _rolling(codes, k)
    seed = i64(adjust_seed(k))
    # sign-flipped keys: a signed compare of them is the uint64 compare
    # (at k = 32 the seed's top bit is set)
    key = umin(fwd ^ seed, rev ^ seed) ^ INT64_MIN
    ends = torch.arange(L, device=dev).expand(R, L)
    # leftmost minimum of key[i-w'+1 .. i]: from the oldest value rightwards
    # only a strictly smaller one takes over
    m = _shift_right(key, wp - 1, fill=i64((1 << 64) - 1) ^ INT64_MIN)
    am = ends - (wp - 1)
    for d in range(wp - 2, -1, -1):
        cand = _shift_right(key, d)
        take = cand < m
        m = torch.where(take, cand, m)
        am = torch.where(take, ends - d, am)
    first = k + wp - 2
    emit = (ends == first) | ((ends > first)
                              & (am != _shift_right(am, 1, fill=-1)))
    emit &= ends < lengths.to(torch.int64)[:, None]
    vals = torch.where(emit, m ^ INT64_MIN, torch.zeros_like(m))
    hi, lo = split32(vals)
    return hi, lo, emit, emit.sum(dim=1, dtype=torch.int32)
