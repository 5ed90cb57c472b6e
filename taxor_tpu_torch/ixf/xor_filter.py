"""Interleaved XOR filter (IXF): host-side construction + numpy query oracle.

The reference's core data structure is ``seqan3::interleaved_xor_filter``
from a seqan3 fork that is fetched at build time (not in-tree).  Behavior is
reconstructed from its call sites (src/hixf/build/construct_ixf.cpp,
hierarchical_interleaved_xor_filter.hpp) plus the in-tree single-filter
algorithm reference (src/main/xorfilter.hpp):

  - B technical bins share one (block_length, seed); each bin stores 8-bit
    fingerprints in a 3-block XOR filter; arrays are interleaved bin-major
    per slot, i.e. ``fingerprints[slot, bin]``, so one probe touches a
    contiguous row of all bins — exactly the layout the TPU gather kernel
    wants.
  - sizing: arrayLength = 32 + 1.23 * max_elements_per_bin (integer
    truncation), block_length = arrayLength / 3 (xorfilter.hpp:67-68);
    usable slots = 3 * block_length.
  - hashing: mixed = murmur64(key + seed) with the fixed start seed
    13572355802537770549 (xorfilter.hpp:153); probe slot i =
    reduce32(rotl64(mixed, 21*i), block_length) + i*block_length
    (xorfilter.hpp:42-45,342-347); fingerprint = uint8(mixed ^ mixed>>32).
  - membership <=> fp[h0] ^ fp[h1] ^ fp[h2] ^ fingerprint == 0
    (xorfilter.hpp:348-349).
  - construction: 3-regular hypergraph peeling + reverse assignment.  On
    any bin failing to peel, the whole IXF is rebuilt with a fresh seed
    (construct_ixf.cpp:100-108).  The reference reseeds from
    ``std::random_device`` (nondeterministic); we use the deterministic
    chain seed' = murmur64(seed) instead (documented divergence — strictly
    more reproducible, same failure semantics).

Construction here is a *round-synchronous batch peeling*: each round
removes every key incident to a degree-1 slot at once (claims are
conflict-free because a degree-1 slot has exactly one incident key).
This converges to the same peelability fixed point as the reference's
stack algorithm and assigns fingerprints by reverse round order.  The
hot loop has two byte-identical implementations: the C++ core
(native/xor_peel.cpp, threaded over bins — the framework's counterpart
of the reference's construct_ixf.cpp native loop, ~15x the numpy speed)
and the numpy fallback below.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..utils.u64np import (
    XOR_SEED0,
    fingerprint8,
    mix_split,
    murmur64,
    probe_positions,
)

U64 = np.uint64


def ixf_geometry(max_elements_per_bin: int) -> tuple[int, int]:
    """(block_length, slots) for a given per-bin capacity.

    Documented divergence: the in-tree reference uses 32 + 1.23*n
    (xorfilter.hpp:67), but 1.23 sits 0.7% above the 3-core peeling
    threshold (c* = 1.2218) where mid-size bins fail to peel several
    percent of the time — fatal when hundreds of bins must all peel under
    one shared seed.  We use 48 + 1.32*n (+7% memory) which pushes
    non-collision failures to ~0; see also the duplicate-triple handling
    in build_ixf.
    """
    array_length = int(48 + math.ceil(1.32 * max_elements_per_bin))
    block_length = array_length // 3
    return block_length, 3 * block_length


def compute_probes(keys: np.ndarray, seed: int, block_length: int):
    """(positions int64 [n,3], fingerprints uint8 [n]) for uint64 keys."""
    mixed = mix_split(np.asarray(keys, dtype=U64), seed)
    return probe_positions(mixed, block_length), fingerprint8(mixed), mixed


def _peel_bin(positions: np.ndarray):
    """Batch peeling of one bin.

    positions: int64 [n, 3] probe slots per key.
    Returns (order_key_idx, order_slot) arrays in *assignment* order
    (peeling order; fill in reverse), or None if peeling failed.
    """
    n = positions.shape[0]
    if n == 0:
        return []
    alive = np.ones(n, dtype=bool)
    rounds: list[tuple[np.ndarray, np.ndarray]] = []
    n_slots = int(positions.max()) + 1 if n else 0
    remaining = n
    while remaining:
        pos_alive = positions[alive]
        counts = np.bincount(pos_alive.ravel(), minlength=n_slots)
        deg1 = counts == 1
        claim = deg1[positions] & alive[:, None]  # [n,3]
        peelable = claim.any(axis=1)
        if not peelable.any():
            return None  # 2-core non-empty -> retry with new seed
        kidx = np.nonzero(peelable)[0]
        probe = np.argmax(claim[kidx], axis=1)
        slots = positions[kidx, probe]
        rounds.append((kidx, slots))
        alive[kidx] = False
        remaining -= kidx.shape[0]
    return rounds


@dataclass
class IXF:
    """One interleaved XOR filter level."""

    fingerprints: np.ndarray  # uint8 [slots, bins]
    block_length: int
    seed: int

    @property
    def bin_count(self) -> int:
        return self.fingerprints.shape[1]

    @property
    def slots(self) -> int:
        return self.fingerprints.shape[0]

    def bulk_membership(self, keys: np.ndarray) -> np.ndarray:
        """bool [n, bins] membership matrix (numpy oracle)."""
        keys = np.asarray(keys, dtype=U64)
        if keys.size == 0:
            return np.zeros((0, self.bin_count), dtype=bool)
        pos, fpr, _ = compute_probes(keys, self.seed, self.block_length)
        rows = self.fingerprints[pos]  # [n, 3, bins]
        x = rows[:, 0] ^ rows[:, 1] ^ rows[:, 2] ^ fpr[:, None]
        return x == 0

    def bulk_count(self, keys: np.ndarray) -> np.ndarray:
        """int64 [bins] per-bin hit counts — the reference counting agent
        (hierarchical_interleaved_xor_filter.hpp:307-310)."""
        return self.bulk_membership(keys).sum(axis=0)


def _build_bins_native(bins, seed: int, block_length: int, slots: int,
                       threads: int) -> np.ndarray | None:
    """One construction attempt via the C++ core (native/xor_peel.cpp):
    fingerprint table on success, None on a peeling failure (caller
    reseeds) — byte-identical to _build_bins_python.  Returns None also
    when the native library is unavailable."""
    import ctypes

    from ..native import get_lib

    lib = get_lib()
    if lib is None or not hasattr(lib, "ixf_build_bins"):
        return None
    n_bins = len(bins)
    offsets = np.zeros(n_bins + 1, dtype=np.int64)
    for b, keys in enumerate(bins):
        offsets[b + 1] = offsets[b] + keys.shape[0]
    concat = (
        np.concatenate(bins) if offsets[-1] else np.zeros(0, dtype=U64)
    )
    concat = np.ascontiguousarray(concat, dtype=U64)
    fp = np.zeros((slots, n_bins), dtype=np.uint8)
    rc = lib.ixf_build_bins(
        concat.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        n_bins,
        ctypes.c_ulonglong(seed),
        block_length,
        fp.ctypes.data_as(ctypes.c_void_p),
        n_bins,
        max(1, threads),
    )
    return fp if rc < 0 else None


def _build_bins_python(bins, seed: int, block_length: int,
                       slots: int) -> np.ndarray | None:
    """One construction attempt in numpy (fallback + oracle for the
    native core): fingerprint table, or None on peeling failure."""
    n_bins = len(bins)
    fp = np.zeros((slots, n_bins), dtype=np.uint8)
    for b, keys in enumerate(bins):
        if keys.shape[0] == 0:
            continue
        pos, fpr, _ = compute_probes(keys, seed, block_length)
        # Keys colliding on all 3 probe slots are jointly unsatisfiable
        # (one fingerprint cell chain cannot encode two different
        # fingerprints) and would force a full-IXF reseed every time a
        # single pair collides anywhere — hopeless for thousands of
        # bins.  Documented divergence: keep the first key of each
        # triple, drop the rest (the dropped key false-negatives in
        # this bin with probability ~n/bl^3 per key, negligible for
        # count-based classification).
        _, first_idx = np.unique(pos, axis=0, return_index=True)
        if first_idx.shape[0] != keys.shape[0]:
            keep = np.sort(first_idx)
            pos = pos[keep]
            fpr = fpr[keep]
        rounds = _peel_bin(pos)
        if rounds is None:
            return None
        # Reverse assignment (xorfilter.hpp:308-328), one vectorized
        # fill per peel round.  Within a round claims are distinct and
        # no key's other slots are claimed in the same round, so the
        # reads never see same-round writes; the claimed slot itself is
        # still 0, so XOR-ing all three probe slots equals the
        # reference's "skip the found slot" formula.
        for kidx, claimed in reversed(rounds):
            fp[claimed, b] = (
                fpr[kidx]
                ^ fp[pos[kidx, 0], b]
                ^ fp[pos[kidx, 1], b]
                ^ fp[pos[kidx, 2], b]
            )
    return fp


def build_ixf(
    per_bin_keys: list[np.ndarray],
    max_elements_per_bin: int | None = None,
    seed: int = XOR_SEED0,
    max_retries: int = 64,
    threads: int = 0,
    force_python: bool = False,
) -> IXF:
    """Construct an IXF holding each bin's uint64 key set.

    Mirrors both reference ctors: explicit per-bin element lists
    (construct_ixf.cpp:35-47) and {bin_count, max_elements} sizing
    (construct_ixf.cpp:28,58).  All bins share geometry and seed; a peeling
    failure in any bin retries the whole filter with the next seed.

    The hot loop runs in the C++ core (native/xor_peel.cpp, threaded
    over bins — the analog of the reference's construct_ixf +
    add_bin_elements), falling back to the byte-identical numpy batch
    peeler when no compiler is available (or force_python=True).
    """
    if threads <= 0:
        import os

        threads = os.cpu_count() or 1
    bins = [np.unique(np.asarray(b, dtype=U64)) for b in per_bin_keys]
    if max_elements_per_bin is None:
        max_elements_per_bin = max((b.shape[0] for b in bins), default=0)
    block_length, slots = ixf_geometry(max_elements_per_bin)
    n_bins = len(bins)
    for b, keys in enumerate(bins):
        if keys.shape[0] > max_elements_per_bin:
            raise ValueError(
                f"bin {b} holds {keys.shape[0]} keys > capacity "
                f"{max_elements_per_bin}"
            )

    for attempt in range(max_retries):
        if force_python:
            fp = _build_bins_python(bins, seed, block_length, slots)
        else:
            fp = _build_bins_native(bins, seed, block_length, slots,
                                    threads)
            if fp is None:  # unavailable OR failed: disambiguate once
                from ..native import get_lib

                if get_lib() is None or not hasattr(
                        get_lib(), "ixf_build_bins"):
                    fp = _build_bins_python(bins, seed, block_length,
                                            slots)
        if fp is not None:
            return IXF(fingerprints=fp, block_length=block_length,
                       seed=seed)
        seed = int(murmur64(np.uint64(seed)))
        if attempt % 8 == 7:
            # many SMALL bins under one shared seed make reseeding alone
            # hopeless: at n ~ 300 the finite-size peel failure rate per
            # bin is ~0.1-0.5%, so with 10^4+ bins EVERY seed has an
            # expected failure.  Escalate the array size instead — each
            # +8% step cuts the per-bin failure rate by orders of
            # magnitude (the reference, which reseeds forever from
            # random_device, can spin on exactly this shape)
            max_elements_per_bin = int(max_elements_per_bin * 1.08) + 8
            block_length, slots = ixf_geometry(max_elements_per_bin)
    raise RuntimeError(
        f"IXF peeling failed after {max_retries} seeds "
        f"(bins={n_bins}, capacity={max_elements_per_bin})"
    )
