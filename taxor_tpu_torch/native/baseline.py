"""Python wrapper around the native reference-algorithm search baseline.

Flattens a host HIXF into the contiguous views ref_baseline.cpp consumes
and runs the reference's full per-read worker job (syncmer scan -> dedup ->
per-read threshold -> recursive HIXF membership -> 0.8*max filter) on N
CPU threads.  This is the honest stand-in for a 32-thread run of the
reference binary (src/main/taxor_search.cpp:196-313) used by
tools/bench.py.  The port's copy of taxor_tpu/native/baseline.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..hash.encode import encode_dna4
from . import get_lib

U64 = np.uint64


def flatten_hixf(hixf):
    """Contiguous arrays describing the HIXF for the native kernel."""
    n = len(hixf.ixfs)
    fp_parts, fp_off = [], np.zeros(n + 1, dtype=np.int64)
    bins = np.zeros(n, dtype=np.int64)
    block_len = np.zeros(n, dtype=np.int64)
    seeds = np.zeros(n, dtype=np.uint64)
    bin_off = np.zeros(n + 1, dtype=np.int64)
    user_parts, next_parts = [], []
    for i, ixf in enumerate(hixf.ixfs):
        fp = np.ascontiguousarray(ixf.fingerprints)
        fp_parts.append(fp.reshape(-1))
        fp_off[i + 1] = fp_off[i] + fp.size
        bins[i] = ixf.bin_count
        block_len[i] = ixf.block_length
        seeds[i] = ixf.seed
        bin_off[i + 1] = bin_off[i] + ixf.bin_count
        user_parts.append(hixf.bin_to_user[i].astype(np.int32))
        next_parts.append(hixf.next_ixf_id[i].astype(np.int32))
    return dict(
        fp=np.concatenate(fp_parts),
        fp_off=fp_off,
        bins=bins,
        block_len=block_len,
        seeds=seeds,
        bin_off=bin_off,
        user_of=np.concatenate(user_parts),
        next_ixf=np.concatenate(next_parts),
        n_ixfs=n,
    )


def baseline_search(hixf, seqs: list[bytes], scheme, thresholder,
                    threads: int = 32):
    """(best_user, best_count, n_pass) int32 arrays, one entry per read.

    Only count-only threshold models (percentage / syncmer / kmer) are
    supported — matching the reference configs the bench exercises.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    assert scheme.use_syncmer, "baseline implements the syncmer worker"

    flat = flatten_hixf(hixf)
    # search-side encoding: dna4, N -> A with no scanner reset
    # (src/main/taxor_search.cpp:210-259 uses dna4 query traits)
    codes_list = [encode_dna4(s) for s in seqs]
    read_off = np.zeros(len(seqs) + 1, dtype=np.int64)
    for i, c in enumerate(codes_list):
        read_off[i + 1] = read_off[i] + c.shape[0]
    codes = (np.concatenate(codes_list) if len(codes_list)
             else np.zeros(0, dtype=np.uint8))
    codes = np.ascontiguousarray(codes, dtype=np.uint8)

    thr_cap = max(int(read_off[i + 1] - read_off[i]) for i in range(len(seqs)))
    thr_table = np.zeros(thr_cap + 1, dtype=np.uint64)
    for c in range(thr_cap + 1):
        thr_table[c] = thresholder.get(c, 0.0) % (1 << 64)

    n = len(seqs)
    best_user = np.empty(n, dtype=np.int32)
    best_count = np.empty(n, dtype=np.int32)
    npass = np.empty(n, dtype=np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    rc = lib.ref_baseline_search(
        ptr(codes), ptr(read_off), n,
        scheme.kmer_size, scheme.syncmer_size, scheme.t_syncmer,
        ptr(flat["fp"]), ptr(flat["fp_off"]), flat["n_ixfs"],
        ptr(flat["bins"]), ptr(flat["block_len"]), ptr(flat["seeds"]),
        ptr(flat["bin_off"]), ptr(flat["user_of"]), ptr(flat["next_ixf"]),
        ptr(thr_table), thr_cap,
        ptr(best_user), ptr(best_count), ptr(npass),
        threads,
    )
    if rc != 0:
        raise RuntimeError(f"ref_baseline_search rc={rc}")
    return best_user, best_count, npass
