"""The search kernels' launch counts, read and reset in one place.

Each wrapper adds one to its ``LAUNCHES`` where it launches its kernel
and nowhere else (a CPU tensor takes the plain twin and counts nothing);
K1 and syncmer_track also count their instance in ``SMER_BITS``, K2 its
route in ``k2_counts.VARIANTS``, K2n its mode in
``k2n_counts.MODES``, and both their caller in ``ROUTES``."""

from __future__ import annotations

from . import extract, probe, sort


def read() -> dict:
    """The counts so far, by the kernels' names: K1, K2, K2n, K2 by
    route, K2n by mode, the split engine's syncmer_track and K3, K4, K5,
    K6, K1's and syncmer_track's 64-bit s-mer instances, and K2's and
    K2n's launches by caller."""
    return {"K1": extract.syncmer_hashes.LAUNCHES,
            "K2": probe.k2_counts.LAUNCHES, "K2n": probe.k2n_counts.LAUNCHES,
            "K2 slab": probe.k2_counts.VARIANTS.get("slab", 0),
            "K2 rows": probe.k2_counts.VARIANTS.get("rows", 0),
            "K2n smem": probe.k2n_counts.MODES.get("smem", 0),
            "K2n rows": probe.k2n_counts.MODES.get("rows", 0),
            "K1 s64": extract.syncmer_hashes.SMER_BITS.get(64, 0),
            "track": extract.syncmer_track.LAUNCHES,
            "track s64": extract.syncmer_track.SMER_BITS.get(64, 0),
            "K3": sort.dedup_fused.LAUNCHES, "K4": sort.sort_pairs.LAUNCHES,
            "K6": sort.unique_pairs.LAUNCHES,
            "K5": extract.minimizer_kmers.LAUNCHES,
            "K2 routes": dict(probe.k2_counts.ROUTES),
            "K2n routes": dict(probe.k2n_counts.ROUTES)}


def since(before: dict) -> dict:
    """The launches of each kernel after ``before`` (an earlier
    ``read()``); the by-caller counts left out."""
    now = read()
    return {k: v - before[k] for k, v in now.items() if isinstance(v, int)}


def reset() -> None:
    """Every count to 0."""
    for k in (extract.syncmer_hashes, extract.syncmer_track,
              extract.minimizer_kmers, sort.dedup_fused, sort.sort_pairs,
              sort.unique_pairs):
        k.LAUNCHES = 0
    for k in (extract.syncmer_hashes, extract.syncmer_track):
        k.SMER_BITS = {}
    for k in (probe.k2_counts, probe.k2n_counts):
        k.LAUNCHES = 0
        k.ROUTES = {}
    probe.k2_counts.VARIANTS = {}
    probe.k2n_counts.MODES = {}
