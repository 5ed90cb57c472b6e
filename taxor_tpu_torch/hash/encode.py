"""Sequence byte-string -> 2-bit code arrays, matching the reference's
three distinct alphabet behaviors:

  - dna4 semantics ("N" and every other ambiguity code silently becomes A,
    rank 0): used by the *index hash* path and by the *search* path, which
    both read sequences through dna4 traits
    (src/hixf/build/dna4_traits.hpp:15-18, src/main/taxor_search.cpp:181).
  - dna5 semantics (N kept, code 4, resets the rolling scanner): used only
    by the build-time HLL *counting* path (src/main/taxor_build.cpp:299,367
    use the default dna traits) via the syncmer scanner's N-reset
    (src/hashing/syncmer.cpp:147-153).
  - The index hash path additionally strips N stretches by concatenating
    the non-N segments and — reference quirk — drops the LAST base of any
    record whose trailing segment runs to the end of the sequence
    (src/hixf/build/compute_hashes.cpp:27-35: ``substr(start, len-start-1)``).
    With dna4 traits there are no Ns left, so in practice every record
    loses its final base.  ``build_record_seq`` reproduces this exactly.
"""

from __future__ import annotations

import numpy as np

# Translate ASCII -> 2-bit code, dna4 semantics (unknown -> A/0).
# A/a->0, C/c->1, G/g->2, T/t/U/u->3, everything else -> 0.
_DNA4 = np.zeros(256, dtype=np.uint8)
# dna4 ambiguity resolution in seqan3 maps e.g. N->A, R->A, Y->C ... but the
# reference pipelines only ever contain ACGTUN in practice; we follow the
# seqan3 rule "unknown -> A" for everything non-ACGTU.
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _DNA4[ord(ch)] = code
    _DNA4[ord(ch.lower())] = code

# dna5 semantics: same codes, unknown -> 4 (seq_nt4_table, syncmer.cpp:53-70).
_DNA5 = np.full(256, 4, dtype=np.uint8)
for ch, code in (("A", 0), ("C", 1), ("G", 2), ("T", 3), ("U", 3)):
    _DNA5[ord(ch)] = code
    _DNA5[ord(ch.lower())] = code


def encode_dna4(seq: bytes) -> np.ndarray:
    """bytes -> uint8 codes in {0..3}; ambiguity codes become 0 (A)."""
    return _DNA4[np.frombuffer(seq, dtype=np.uint8)]


def encode_dna5(seq: bytes) -> np.ndarray:
    """bytes -> uint8 codes in {0..4}; 4 marks an N-like base."""
    return _DNA5[np.frombuffer(seq, dtype=np.uint8)]


def cut_out_n_stretches(seq: bytes) -> bytes:
    """Reference cutOutNNNs: concatenate non-'N' segments; if the final
    segment extends to the end of the sequence, its last byte is dropped
    (compute_hashes.cpp:21-41).  Only uppercase 'N' is recognized, exactly
    like the reference's std::string::find("N")."""
    parts = []
    n = len(seq)
    start = 0
    while True:
        # find_first_not_of("N", start)
        while start < n and seq[start : start + 1] == b"N":
            start += 1
        if start >= n:
            break
        end = seq.find(b"N", start)
        if end == -1:
            parts.append(seq[start : n - 1])  # quirk: drops last base
            break
        parts.append(seq[start:end])
        start = end
    return b"".join(parts)


def build_record_seq(seq: bytes) -> bytes:
    """What the index-hash path actually hashes for one FASTA record.

    The reference reads the record through dna4 (ambiguity -> 'A'), converts
    back to characters, and runs cutOutNNNs (compute_hashes.cpp:50-74).
    After dna4 there are no 'N's, so the net effect is: ambiguity -> 'A',
    then drop the final base.
    """
    if not seq:
        return seq
    return seq[:-1]
