"""Open canonical syncmer extraction.

Reproduces, state transition by state transition, the reference scanner
``make_string_to_hashvalues_open_syncmers_canonical``
(src/hashing/syncmer.cpp:80-155):

  - rolling 2-bit encode of the k-mer and s-mer on both strands
    (forward: ``x<<2|c``; reverse: ``x>>2 | (3-c)<<shift``),
  - canonical s-mer value = min(fwd, rev) of the *raw packed* value,
  - a window of the last w = k-s+1 s-mers with a stateful minimum:
      * first full window: leftmost minimum (forward scan, strict <),
      * on sliding out the current minimum: recompute as the RIGHTMOST
        minimum (reverse scan, strict <, syncmer.cpp:128-136),
      * otherwise a new value only takes over if strictly smaller
        (syncmer.cpp:137-140) — i.e. ties keep the older minimum,
  - emit when the minimum sits at offset t of the k-mer
    (syncmer.cpp:142-146), value = wyhash64(min(kmer_fwd, kmer_rev)),
  - a code >= 4 (N) resets all state (syncmer.cpp:147-153).

The scan is inherently sequential per base; we vectorize across the read
batch (numpy) which is how the host feeds the TPU probe kernels.  The
emitted hash multiset is order-free downstream: the reference inserts into
a hash set (dedup), which we replicate with ``np.unique``.
"""

from __future__ import annotations

import numpy as np

from ..utils.u64np import wyhash64

U64 = np.uint64
_UMAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def syncmer_hashes_scalar(codes: np.ndarray, k: int, s: int, t: int) -> list[int]:
    """Readable single-sequence oracle. ``codes`` are uint8 in {0..4}.

    Returns hashes in emission order (duplicates kept; callers dedup).
    """
    kmask = (1 << (2 * k)) - 1
    smask = (1 << (2 * s)) - 1
    kshift = (k - 1) * 2
    sshift = (s - 1) * 2
    qs: list[int] = []
    qs_min_val = (1 << 64) - 1
    qs_min_pos = -1
    l = 0
    xk0 = xk1 = xs0 = xs1 = 0
    out: list[int] = []
    w = k - s + 1
    for i, c in enumerate(codes):
        c = int(c)
        if c < 4:
            xk0 = ((xk0 << 2) | c) & kmask
            xk1 = (xk1 >> 2) | ((3 - c) << kshift)
            xs0 = ((xs0 << 2) | c) & smask
            xs1 = (xs1 >> 2) | ((3 - c) << sshift)
            l += 1
            if l < s:
                continue
            ys = min(xs0, xs1)
            qs.append(ys)
            if len(qs) < w:
                continue
            if len(qs) == w:
                for j in range(w):
                    if qs[j] < qs_min_val:
                        qs_min_val = qs[j]
                        qs_min_pos = i - k + j + 1
            else:
                qs.pop(0)
                if qs_min_pos == i - k:
                    qs_min_val = (1 << 64) - 1
                    qs_min_pos = i - s + 1
                    for j in range(len(qs) - 1, -1, -1):
                        if qs[j] < qs_min_val:
                            qs_min_val = qs[j]
                            qs_min_pos = i - k + j + 1
                elif ys < qs_min_val:
                    qs_min_val = ys
                    qs_min_pos = i - s + 1
            if qs_min_pos == i - k + t:
                yk = min(xk0, xk1)
                out.append(int(wyhash64(np.uint64(yk))))
        else:
            qs_min_val = (1 << 64) - 1
            qs_min_pos = -1
            l = xs0 = xs1 = xk0 = xk1 = 0
            qs.clear()
    return out


def syncmer_hashes_batch(
    codes: np.ndarray, lengths: np.ndarray, k: int, s: int, t: int
):
    """Vectorized scan across a batch.

    Parameters
    ----------
    codes : uint8 [B, L], values in {0..4}; pad beyond each row's length
        with 4 (acts as N: resets state, never emits).
    lengths : int [B]

    Returns
    -------
    hashes : uint64 [B, L] emission per position
    valid  : bool  [B, L] emission mask
    """
    codes = np.asarray(codes, dtype=np.uint8)
    B, L = codes.shape
    w = k - s + 1

    kmask = U64((1 << (2 * k)) - 1)
    smask = U64((1 << (2 * s)) - 1)
    kshift = U64((k - 1) * 2)
    sshift = U64((s - 1) * 2)

    xk0 = np.zeros(B, dtype=U64)
    xk1 = np.zeros(B, dtype=U64)
    xs0 = np.zeros(B, dtype=U64)
    xs1 = np.zeros(B, dtype=U64)
    lrun = np.zeros(B, dtype=np.int64)  # valid-base run length
    nsmers = np.zeros(B, dtype=np.int64)  # s-mers currently in the queue
    ring = np.zeros((B, w), dtype=U64)  # last w s-mer values, slot = step % w
    ring_step = np.zeros(B, dtype=np.int64)  # per-lane count of pushed s-mers
    qmin_val = np.full(B, _UMAX, dtype=U64)
    qmin_pos = np.full(B, -1, dtype=np.int64)

    out_hash = np.zeros((B, L), dtype=U64)
    out_valid = np.zeros((B, L), dtype=bool)

    # Precompute the ring-read order helper: for ordered window access we
    # need ring slots [(step-w+1+m) % w for m in 0..w-1].
    m_idx = np.arange(w, dtype=np.int64)

    length_arr = np.asarray(lengths, dtype=np.int64)

    with np.errstate(over="ignore"):
        for i in range(L):
            c = codes[:, i].astype(np.int64)
            is_base = (c < 4) & (i < length_arr)
            cu = c.astype(U64)

            # rolling updates (only applied on valid-base lanes)
            nxk0 = ((xk0 << U64(2)) | cu) & kmask
            nxk1 = (xk1 >> U64(2)) | ((U64(3) - cu) << kshift)
            nxs0 = ((xs0 << U64(2)) | cu) & smask
            nxs1 = (xs1 >> U64(2)) | ((U64(3) - cu) << sshift)
            xk0 = np.where(is_base, nxk0, xk0)
            xk1 = np.where(is_base, nxk1, xk1)
            xs0 = np.where(is_base, nxs0, xs0)
            xs1 = np.where(is_base, nxs1, xs1)
            lrun = np.where(is_base, lrun + 1, lrun)

            has_smer = is_base & (lrun >= s)
            ys = np.minimum(xs0, xs1)

            # push into ring
            slot = ring_step % w
            push = has_smer
            ring[np.arange(B)[push], slot[push]] = ys[push]
            nsmers = np.where(push, np.minimum(nsmers + 1, w + 1), nsmers)
            ring_step = np.where(push, ring_step + 1, ring_step)

            first_full = push & (nsmers == w)
            steady = push & (nsmers == w + 1)
            # steady lanes conceptually popped the front; queue stays at w
            nsmers = np.where(steady, w, nsmers)

            # ordered window values for lanes that need a scan
            need_scan_any = first_full.any() or steady.any()
            if need_scan_any:
                # ordered[j] for j=0..w-1 = s-mer starting at i-k+1+j
                base = (ring_step[:, None] - w + m_idx[None, :]) % w
                ordered = np.take_along_axis(ring, base, axis=1)

                # first full window: leftmost min (forward scan, strict <)
                lm = np.argmin(ordered, axis=1)  # numpy argmin = leftmost
                lm_val = np.take_along_axis(ordered, lm[:, None], axis=1)[:, 0]
                # reference compares against carried qs_min_val (UMAX after
                # reset) — strict <, so equal-to-UMAX values cannot win;
                # raw s-mer values are < 2^52, so this never triggers.
                new_val_f = lm_val
                new_pos_f = i - k + lm + 1
                qmin_val = np.where(first_full, new_val_f, qmin_val)
                qmin_pos = np.where(first_full, new_pos_f, qmin_pos)

                # steady state
                popped_was_min = steady & (qmin_pos == i - k)
                # rightmost min: reverse argmin
                rm = (w - 1) - np.argmin(ordered[:, ::-1], axis=1)
                rm_val = np.take_along_axis(ordered, rm[:, None], axis=1)[:, 0]
                qmin_val = np.where(popped_was_min, rm_val, qmin_val)
                qmin_pos = np.where(popped_was_min, i - k + rm + 1, qmin_pos)

                newer_min = steady & ~popped_was_min & (ys < qmin_val)
                qmin_val = np.where(newer_min, ys, qmin_val)
                qmin_pos = np.where(newer_min, i - s + 1, qmin_pos)

            window_ready = first_full | steady
            emit = window_ready & (qmin_pos == i - k + t)
            if emit.any():
                yk = np.minimum(xk0, xk1)
                out_hash[:, i] = np.where(emit, wyhash64(yk), out_hash[:, i])
                out_valid[:, i] = emit

            # N (or padding) resets everything
            reset = ~is_base
            if reset.any():
                qmin_val = np.where(reset, _UMAX, qmin_val)
                qmin_pos = np.where(reset, -1, qmin_pos)
                zero = U64(0)
                xk0 = np.where(reset, zero, xk0)
                xk1 = np.where(reset, zero, xk1)
                xs0 = np.where(reset, zero, xs0)
                xs1 = np.where(reset, zero, xs1)
                lrun = np.where(reset, 0, lrun)
                nsmers = np.where(reset, 0, nsmers)
                ring_step = np.where(reset, 0, ring_step)

    return out_hash, out_valid


def syncmer_hash_set(codes: np.ndarray, k: int, s: int, t: int) -> np.ndarray:
    """Deduplicated syncmer hashes of one sequence (sorted uint64 array) —
    the analog of the reference's hash set return (syncmer.cpp:157-165)."""
    h, v = syncmer_hashes_batch(
        codes[None, :], np.array([codes.shape[0]]), k, s, t
    )
    return np.unique(h[v])


def t_syncmer_default(k: int, s: int) -> int:
    """t = ceil((k - s + 1) / 2) computed with C++ *integer* division, i.e.
    effectively floor (reference quirk, src/main/taxor_build.cpp:370,510)."""
    return (k - s + 1) // 2
