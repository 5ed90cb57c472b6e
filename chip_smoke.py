#!/usr/bin/env python3
"""Smoke test of taxor_tpu_torch on one CUDA GPU (built for the H100).

    python3 chip_smoke.py                 # full size, ~13-16 min on an H100
    python3 chip_smoke.py --genomes 600 --reads 512 --hier-genomes 200 \
        --hier-reads 512                  # quick start check

Phases (any failure exits non-zero):
  1. card and build: prints nvidia-smi's name and power limit, builds
     the CUDA kernels from taxor_tpu_torch/csrc (the search's library and
     the diagnostic library of csrc/diag/, every nvcc started together)
     and times the build;
  2. K1 (syncmer extraction) against its plain twin, bit-exact, at every
     length bucket 256..32768 on random, homopolymer-run, tandem-repeat,
     N-containing and two-letter-alphabet reads, a read whose first
     window is tied and a homopolymer over the whole bucket, plus a gap-1
     scheme whose sort buffer spills to global memory; on the same reads
     the split engine's kernels
     (phase 9): syncmer_track against ``syncmer_kmers`` and K3 (dedup)
     against its twin with hcap above and below the emission count;
  3. the probe (K2, or K2n for tables of at most 512 bins) against its
     plain twin, bit-exact, at the flat geometries of the reference's
     five probe kernels, with invalid slots whose fingerprint is 0 and
     per-bin counts above 256; K2 through the variant its shape picks
     (the slab route where a bin slab of the table fits a block's shared
     memory, else the rows route) and, where that is the slab route,
     through the rows route too; both variants must have run;
  4. the flat main path: a flat k=22/s=12 syncmer index of synthetic
     30 kb genomes built with ``taxor_tpu_torch.cli build``, ONT-like
     reads (log-normal lengths clipped to 500-30,000 bases, 4%
     substitutions) plus reads over L_CAP, searched with
     ``taxor_tpu_torch.cli search --engine device``; K1 and K2's slab
     route must have launched, and the TSV must equal ``--engine host``
     byte for byte on
     a subset; then the same search with the split engine
     (``device.e2e.USE_FUSED_EXTRACT = False``), whose TSV must equal the
     K1 TSV on every read, with syncmer_track and K3 launched and K1 not;
  5. K1 and K2 timed against their twins at the flat path's shapes (K2
     through both variants, with its valid hashes, row bytes and GB/s of
     rows), and K1 on a batch tied in every window (its worst case);
  6. K2n and K2 over stacked tables (G = 1 and 8) with a mixed activity
     mask against their twin, bit-exact, at 16..512 bins (K2n, in both
     modes where its smem mode fits) and 4,096 bins (K2, through both
     variants), with fingerprint-0 slots, counts above 256 and a read
     inactive everywhere; then K2n's run sums (probe_run_sums_grouped)
     against their twin, bit-exact, in both modes, at G = 1, 8 and 72
     (tables of 216 slots like the widest descent group's), 16, 100 and
     512 bins, activity 0%, ~0.5%, 60% and 100%, one-bin runs, runs over
     many bins, a run over a whole subgroup, a subgroup without runs and
     run sums above 256, each call one K2n launch; and the run sums of
     1,000- and 4,096-bin groups, one K2 launch each (dense counts and
     their segment sums: a group past K2n's 512 bins);
  7. the hierarchical main path: the same recipe on an index built with
     ``--layout auto --tmax 64`` (a 64-bin root); K1, the grouped probe
     (K2n in both modes: smem on stacked groups, rows on the root) and
     the per-IXF traversal of the reads over L_CAP must have launched,
     the TSV must equal ``--engine host`` on a subset, and 99% of the
     classified reads must name their source genome; then the split
     engine on the same reads, as in phase 4; then (7b) an index whose
     root has 529 technical bins (a hand-written layout, as the default
     --tmax gives roots past 512 bins), whose root group must take K2 and
     whose grouped step and per-IXF traversal on the card must equal the
     CPU twins;
  8. every group of one descent batch at the hierarchical path's L=8192
     (R=512) and L=4096 (R=1,024) buckets, with the descent's own
     activity masks: (a) the dense K2n counts [G, R, Bpad] and their
     int64 segment sums, what the descent took before K2n summed the
     runs, against (b) the run-sum launch, each as the descent calls it
     (cuda_ms) and on the device alone (tools/time_sort.device_ms: the
     launches queued behind a sleep kernel, so the host's gaps are not
     timed), each group's shape, active pairs, runs and mode logged;
     K2n's run sums timed against their twin on the root and the widest
     group, K2 (the variant each shape
     picks) on the root and the first stacked level;
  9. K4 (pair sort) against its twin, bit-exact, at W = 1, 2, 31, 100,
     128, 1024, 8192, 16384 (the register network at E = 16 and 32) and
     32768 (global scratch), with duplicated keys, keys equal to the
     sentinel, a row of equal keys and a row of sentinels; K3 against its
     twin at every buffer of its register route (Wb = 256-16,384; rows
     of L = 1,000, no multiple of 16 bytes, take byte loads) and the
     global-scratch route (gap 1 at L = 32,768), on rows of 0, 1,
     31-33, 32E +- 1, Wb and Wb + 1 emissions (n_emit = 2**30), of
     all-equal k-mers and of k-mers equal to the sentinel; and,
     after phase 4, K3 against ``sort.dedup_pairs`` (K4) on the flat
     path's L=8192 reads.  No search path reaches K4 (in the JAX package
     only ``sort_impl="pallas"`` does): its record counts 0 main-path
     launches and, apart, the launches of that one check;
 10. syncmer_track, K3 and K4 timed against their twins, K4 against
     ``torch.sort`` of the combined key, and the split engine's
     extraction against K1, at the flat path's L=8192 bucket; K3 and K4
     also on the device alone (device_ms); syncmer_track also on phase
     5's batch tied in every window;
 11. the tools' four diagnostic kernels (csrc/diag/) against their plain
     twins, bit-exact: probe_bounds in its five modes and
     probe_experiment in both position layouts, 1, 2 and 4 reads a
     thread, 4, 8 and 16 ALU rounds and the position-word flood (K = 2,
     4, 8), at R=256 with reads of no hash and past their row of words,
     on the TPU tools' geometry (2,419 slots x 512 bins), the flat
     cell's table, a ragged last slab (100 bins), slabs of 16 bins
     (10,000 slots), a table past the shared memory (20,000 slots) and
     rows of words that 16-byte loads
     cannot take; each through the route its shape
     picks (ROUTES checked) and, where that is the slab route, through
     the rows route too; on tables where every hash hits every bin
     (counts up to 512 a read, and 2,048 on slabs of 128 bins); then
     extract_stage in all ten stages for the schemes STAGE_SCHEMES at
     every length bucket 256..32768 on phase 2's kinds of reads (its
     tied reads drive the walking thread's slide-outs), with its shared
     memory held to ``diag.stage_smem``; and window_shift for all 16
     phases and a reordered list with a repeat on the same reads' stream
     words, and on rows of L/16 - 3 words (no multiple of 4);
 12. the tooling path, with every launch count set to 0 just before it:
     ``tools.bench`` on its primary config (viral_flat_256) with its
     parity gate (five scheme/layout families, device TSV == host TSV),
     ``tools.probe_bounds``, ``tools.probe_experiments`` (its three
     experiment lists) and ``tools.profile_phases`` at the JAX tools'
     sizes (R=8192, H=512, nvalid=173; build_problem's 8,192 reads), and
     ``tools.debug_extract --stage all`` and ``tools.debug_min``, and
     ``cli prewarm`` and ``cli search --profile-trace`` on a small flat
     index (the trace's kernels on the card are counted); both probe
     tools must stay on their slab routes; then the four
     diagnostic kernels timed against their twins, the two probe
     diagnostics also on the device alone and through their rows route
     at the same shape, window_shift also on the device alone, and
     extract_stage in stages sf, chi, erm, emit and pre, pre on a batch
     tied in every window and on one read alone (its serial chain), each
     a call and on the device alone (the record's ``stages``).  Their
     records count the tooling path's launches (``launches_in``:
     "tools"), with phase 11's apart as ``check_launches``, and the two
     probe diagnostics' launches by route (``routes``,
     ``check_routes``); every parity family's device search must have
     taken the fused step (``parity_routes``);
 13. the minimiser and plain k-mer schemes (K5) on the card: (c) K5
     against its twin, bit-exact, at every length bucket 256..32768 on
     phase 2's kinds of reads for (k, window) = (20, 20), (20, 26),
     (18, 26) and (32, 40), without the FracMinHash keep and with the
     keeps of scalings 2, 3 and 1,000 (the twin followed by the keep as
     tensor ops); (a) phase 7's genomes and reads under the bench's
     hier_scaled_minimizer scheme whole (k = 20, --window-size 26,
     --scaling 3, --layout auto --tmax 64) searched with ``--engine
     device``: its fracminhash thresholds take the descend-all descent
     (every pair active), K5 and K2n must launch, every read up to L_CAP
     must take the fused step and only the long ones the host-hash
     route, and the TSV must equal ``--engine host`` on the first
     CHECK_READS reads and the long ones; the share of classified reads
     that name their source genome is logged.  All of phase 7's reads:
     the ~3.5% that the scaled scheme leaves so few hashes that their
     fracminhash threshold is 0 fall back to the host oracle, which
     walks every IXF of the hierarchy for each (in C++,
     ``HIXF.membership``); (b) plain k-mers (k =
     window = 20) on a flat index of 1,024 genomes (K5 at w' = 1, K2
     on a table of ~40,000
     slots: its rows route) with 4,096 reads plus the long ones, checked
     as (a).  **Cut:** from the flat cell's 4,096 genomes and 8,192
     reads, for the script's time limit; (e) the hier_scaled_minimizer
     scheme whole (k = 20, --window-size 26, --scaling 3: the FracMinHash
     keep in K5) on a flat index of (b)'s genomes, searched and
     checked as (a) with (b)'s reads; (d) K5 timed against its twin at
     the L=8192 bucket (R=512) of (a)'s reads, a call and on the device
     alone, for (a)'s scheme with no keep, for plain k-mers and for (a)'s
     scheme with its keep; the keep as tensor ops on K5's output there,
     a call, held to K5's keep and the keep on the CPU;
     K2 at (b)'s own shape (that bucket's reads through K5, H = L hash
     slots, on (b)'s table: the rows route), bit-exact to its twin on
     every read of the batch and timed (the K2 rows record's
     ``kmer_flat``); every group of one descend-all batch of (a)'s index
     at L=8192, each run-sum launch a call and on the device alone
     against its bound (the K2n record's ``descend_all_groups``).  K5's
     record counts the launches of (a), (b) and (e); K2's and K2n's add
     theirs;
 14. the sharded engine on the card, through ``search --engine sharded
     --distributed`` (device/sharding.py, device/distributed.py): each
     rank is a process of this script (``--rank FILE``) that runs
     ``taxor_tpu_torch.cli.main`` with the argv of ``python -m
     taxor_tpu_torch.cli search ...`` and writes its launch counts,
     routes, wall, peak device memory and collective seconds (CUDA
     events around each all_gather and all_reduce) to FILE; ranks that
     share the card run their collectives on gloo, one rank on NCCL.
     (a) phase 4's flat cell, all its reads, 4 ranks on a 2 x 2 mesh; (b)
     phase 7's hierarchy, all its reads, 4 ranks on a 2 x 2 mesh; (c)
     phase 13a's scaled minimiser hierarchy (descend-all), 2 ranks with
     --mesh-bins 2; (d) phase 4's flat cell on one rank (NCCL); (e)
     ``tools.dryrun_multichip`` over 4 ranks.  Every rank must exit 0,
     each TSV must equal the phase's single-device ``--engine device``
     TSV byte for byte on every read, and K1 and K2 ((a), (d); K2n on a
     quick start's flat shard of at most 512 bins), K1 and K2n ((b)), K5
     and K2n ((c)) must launch in the ranks.  The kernels
     records' ``sharded_launches`` sum the ranks' launches of (a)-(d).

Every kernel's record holds its least time on the card (``bound_ms``):
the larger of its bytes (each input read once, each output written
once) over the H100's 3.35 TB/s and its operations over the peak rate
for their type (the H100's dense peak rates; 64-bit key compares and
the tracker's integer operations, which have no entry, at the 67
TFLOP/s scalar fp32 rate; ``tracker_ops`` counts them).

The second-to-last line of stdout is nvidia-smi's name and power limit;
the last line is {"ok": true, "device": {"platform": "gpu", ...}}.  The
line before them holds the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K, S = 22, 12  # the reference's published syncmer scheme
# extract_stage's schemes (k, s, t) in phase 11: the published one, the
# widest window (w = 18), the shortest s-mer (s = 2, t = w = 14), t = w = 11
STAGE_SCHEMES = ((22, 12, 5), (32, 15, 1), (15, 2, 14), (21, 11, 11))
GENOME_LEN = 30000
LONG_READS = 16  # of 40 kb: over L_CAP, the host-hash route
TMAX = 64  # technical bins per IXF of the hierarchical index
CHECK_READS = 1024  # first reads held byte-equal to --engine host
SEED = 20261016
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_SCALAR = 67e12  # fp32 outside the tensor cores: integer/compare work
PEAK_INT8 = 1979e12  # int8 (fingerprint bytes)
SMEM_BPS = 128 * 132 * 1.98e9  # H100 shared memory: 128 B a clock an SM


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(label: str):
    """Logs the wall seconds of the block."""
    t0 = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - t0:.1f} s")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ------------------------------------------------------------------ K1 --
def k1_reads(rng, L: int) -> list[bytes]:
    """Random reads of the bucket plus the tracker's hard cases: tied
    window minima (homopolymer runs, a tandem repeat, two-letter
    alphabets, a first window tied at every offset, a homopolymer over
    the whole bucket), N codes, and reads without a k-mer."""
    half = max(1, L // 2)
    seqs = [ACGT[rng.integers(0, 4, int(rng.integers(half, L + 1)))]
            .tobytes() for _ in range(10)]
    seqs.append(ACGT[rng.integers(0, 4, L)].tobytes())  # full bucket
    arr = ACGT[rng.integers(0, 4, L)].copy()
    for _ in range(max(1, L // 256)):  # homopolymer runs: tied minima
        off = int(rng.integers(0, L - 40))
        arr[off:off + int(rng.integers(13, 40))] = ACGT[rng.integers(0, 4)]
    seqs.append(arr.tobytes())
    unit = ACGT[rng.integers(0, 4, int(rng.integers(2, 7)))].tobytes()
    seqs.append((unit * (L // len(unit) + 1))[:L])  # tandem repeat
    arr = ACGT[rng.integers(0, 4, L - 7)].copy()
    arr[rng.integers(0, L - 7, L // 50)] = ord("N")  # ambiguity codes
    seqs.append(arr.tobytes())
    seqs += [b"", ACGT[rng.integers(0, 4, K - 1)].tobytes()]  # no k-mer
    for pair in (b"AC", b"AT", b"CG"):  # two letters: ties everywhere
        two = np.frombuffer(pair, np.uint8)
        seqs.append(two[rng.integers(0, 2, int(rng.integers(half, L + 1)))]
                    .tobytes())
    seqs.append(b"A" * (K + 2)  # the first window tied at every offset
                + ACGT[rng.integers(0, 4, L - K - 2)].tobytes())
    seqs.append(ACGT[int(rng.integers(0, 4))].tobytes() * L)  # all tied
    return seqs


def assert_equal(torch, label: str, names, got, want) -> None:
    torch.cuda.synchronize()
    for name, a, b in zip(names, got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {name} differs from the twin")


def check_k1(torch, dsync, extract, sort, rng) -> None:
    """K1, and the split engine's syncmer_track and K3, against their
    twins on the same reads."""
    dev = torch.device("cuda")
    cases = [(L, K, S, (K - S + 1) // 2) for L in
             (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)]
    cases.append((32768, 14, 12, 1))  # gap 1: 256 KB sort buffer in global
    for L, k, s, t in cases:
        seqs = k1_reads(rng, L)
        packed, lengths = dsync.pack_reads(seqs, L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        hcap = dsync.hash_cap(L)
        got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
        want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
        assert_equal(torch, f"K1 L={L} k={k} s={s}", ("hi", "lo", "valid",
                     "n_unique", "n_emit"), got, want)
        log(f"K1 L={L} k={k} s={s} t={t}: bit-exact vs twin on {len(seqs)} "
            f"reads (n_emit max {int(got[4].max())}, hcap {hcap}, sort width "
            f"{extract.sort_width(L, k, s, t)})")
        kmer, emit = extract.syncmer_track(pk, ln, k, s, t)
        assert_equal(torch, f"syncmer_track L={L} k={k} s={s}",
                     ("kmer", "emit"), (kmer, emit),
                     dsync.syncmer_kmers(pk, ln, k, s, t))
        gap = dsync.emission_min_gap(k, s, t)
        for hc in (hcap, hcap // 8):
            assert_equal(torch, f"K3 L={L} k={k} s={s} hcap={hc}",
                         ("kmer", "valid", "n_unique", "n_emit"),
                         sort.dedup_fused(kmer, emit, hc, gap),
                         sort.dedup_fused_plain(kmer, emit, hc, gap))
        Wb = sort.dedup_width(L, gap)
        where = ("global scratch" if Wb > sort.REG_SORT_MAX
                 else "registers")
        log(f"syncmer_track + K3 L={L} k={k} s={s} t={t}: bit-exact vs "
            f"twins ({int(emit.sum())} emissions; K3 at hcap {hcap} and "
            f"{hcap // 8}, buffer {Wb} in {where})")


# ------------------------------------------------------------------ K2 --
def check_k2(torch, probe, rng) -> int:
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    # (label, reference kernel at this geometry, block_length, bins)
    geoms = [("bl<=1023, B<4096", "_kernel_p10x2", 1000, 1000),
             ("bl>1023, B<4096", "_kernel_p16", 5000, 2000),
             ("B>=4096", "_kernel_wide_p16", 2000, 5000),
             ("S+1>65536", "_kernel", 30000, 64),
             ("S+1>65536, B>=4096", "_kernel_wide", 22000, 4096)]
    R, H = 8, 2048
    variants = probe.k2_counts.VARIANTS
    start = dict(variants)
    for label, ref, bl, B in geoms:
        S_ = 3 * bl
        Bp = probe.pad_bins(B)
        table = rng.integers(0, 256, (S_, Bp), dtype=np.uint8)
        table[:, ::7] = 0  # zero columns: every fingerprint-0 hash hits
        keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
        keys[0] = zero_fp[:H]  # read 0 counts > 256 in the zero columns
        valid = rng.random((R, H)) < 0.7
        valid[1] = False
        hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
        lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (hi, lo, valid)]
        tbl = torch.from_numpy(table).to(dev)
        n2, n2n = probe.k2_counts.LAUNCHES, probe.k2n_counts.LAUNCHES
        before = dict(variants)
        got = probe.probe_counts(*args, tbl, seed, bl)
        want = probe.probe_counts_plain(*args, tbl, seed, bl)
        torch.cuda.synchronize()
        grew = {v: n - before.get(v, 0) for v, n in variants.items()
                if n != before.get(v, 0)}
        one = (list(grew.values()) == [1] if probe.k2_counts.LAUNCHES > n2
               else not grew)
        if (probe.k2_counts.LAUNCHES + probe.k2n_counts.LAUNCHES
                != n2 + n2n + 1 or not one):
            raise AssertionError(
                f"probe {label}: one call launched K2 "
                f"{probe.k2_counts.LAUNCHES - n2} and K2n "
                f"{probe.k2n_counts.LAUNCHES - n2n} times, K2 variants "
                f"{grew}; expected one launch of one kernel")
        kernel = "K2n" if probe.k2n_counts.LAUNCHES > n2n else \
            f"K2 ({next(iter(grew))})"
        if not torch.equal(got, want):
            raise AssertionError(f"{kernel} {label}: counts differ from the "
                                 "twin")
        if int(got.max()) <= 256 or int(got[1].abs().sum()) != 0:
            raise AssertionError(f"K2 {label}: case did not exercise "
                                 "counts > 256 / all-invalid reads")
        also = ""
        if kernel == "K2 (slab)":  # the same counts through the rows route
            if not torch.equal(probe.k2_counts(*args, tbl[None], None, seed,
                                               bl, variant="rows")[0], want):
                raise AssertionError(f"K2 (rows) {label}: counts differ "
                                     "from the twin")
            also = "; K2 (rows) bit-exact too"
        log(f"{kernel} {label} (S={S_}, Bpad={Bp}; TPU {ref}): bit-exact vs "
            f"twin, max count {int(got.max())}{also}")
    ran = {v: n - start.get(v, 0) for v, n in variants.items()}
    if not (ran.get("slab", 0) > 0 and ran.get("rows", 0) > 0):
        raise AssertionError(f"phase 3 did not run both K2 variants: {ran}")
    log(f"phase 3: K2 launches by variant {ran}")
    return ran["rows"]


def check_grouped(torch, probe, rng) -> int:
    """K2n and K2 over G stacked tables with a mixed activity mask;
    returns the launches of K2's rows route."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    bl, R, H = 3000, 16, 2048
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero_fp[:H]  # read 0 counts > 256 in the zero columns
    valid = rng.random((R, H)) < 0.7
    valid[1] = False  # no valid slot
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (hi, lo, valid)]
    start = dict(probe.k2_counts.VARIANTS)
    for Bp in (16, 64, 128, 512, 4096):
        kernel = (probe.k2n_counts if Bp <= probe.NARROW_MAX_BINS
                  else probe.k2_counts)
        for G in (1, 8):
            tables = rng.integers(0, 256, (G, 3 * bl, Bp), dtype=np.uint8)
            tables[:, :, ::7] = 0
            active = rng.random((G, R)) < 0.5
            active[:, 0] = True
            active[:, R - 1] = False  # a read inactive everywhere
            tb = torch.from_numpy(tables).to(dev)
            act = torch.from_numpy(active).to(dev)
            n = kernel.LAUNCHES
            got = probe.probe_counts_grouped(*args, tb, act, seed, bl)
            want = probe.probe_counts_grouped_plain(*args, tb, act, seed, bl)
            torch.cuda.synchronize()
            if kernel.LAUNCHES != n + 1 or not torch.equal(got, want):
                raise AssertionError(f"grouped probe Bpad={Bp} G={G}: "
                                     "kernel differs from the twin")
            if kernel is probe.k2_counts and not torch.equal(
                    probe.k2_counts(*args, tb, act, seed, bl,
                                    variant="rows"), want):
                raise AssertionError(f"grouped K2 (rows) Bpad={Bp} G={G}: "
                                     "kernel differs from the twin")
            k2n_modes = []
            if kernel is probe.k2n_counts:  # each mode that fits
                k2n_modes = ["rows"] + (
                    ["smem"] if probe.narrow_mode(3 * bl, Bp, dev) == "smem"
                    else [])
                for mode in k2n_modes:
                    if not torch.equal(probe.k2n_counts(
                            *args, tb, act, seed, bl, mode=mode), want):
                        raise AssertionError(
                            f"grouped K2n ({mode}) Bpad={Bp} G={G}: kernel "
                            "differs from the twin")
            if (int(got[:, 0].max()) <= 256
                    or int(got[:, R - 1].abs().sum()) != 0):
                raise AssertionError(f"grouped probe Bpad={Bp} G={G}: case "
                                     "did not exercise counts > 256 / "
                                     "inactive reads")
            name = (f"K2n ({' and '.join(k2n_modes)})"
                    if kernel is probe.k2n_counts else
                    f"K2 (slab of {probe.slab_bins(3 * bl, Bp, dev)} bins, "
                    "and rows)")
            log(f"{name} grouped Bpad={Bp} G={G} (S={3 * bl}, R={R}, H={H}, "
                f"{int(active.sum())}/{G * R} active): bit-exact vs twin, "
                f"max count {int(got.max())}")
    ran = {v: n - start.get(v, 0) for v, n in probe.k2_counts.VARIANTS.items()}
    if not (ran.get("slab", 0) > 0 and ran.get("rows", 0) > 0):
        raise AssertionError(f"phase 6 did not run both K2 variants: {ran}")
    log(f"phase 6: K2 launches by variant {ran}")
    return ran["rows"]


def run_csr(rng, G: int, bins: int):
    """int64 (run_off [G + 1], run_s, run_e): one-bin runs and runs over
    many bins with unused columns between them; subgroup 0 one run over
    all of its bins, subgroup 1 (where there is one) no run."""
    offs, starts, ends = [0], [], []
    for g in range(G):
        if g == 0:
            starts.append(0)
            ends.append(bins)
        elif g != 1:
            col = 0
            while col < bins:
                e = min(bins, col + int(rng.choice([1, 1, 2, 5, 16, 60])))
                starts.append(col)
                ends.append(e)
                col = e + int(rng.integers(0, 3))
        offs.append(len(starts))
    return tuple(np.array(x, dtype=np.int64) for x in (offs, starts, ends))


def check_run_sums(torch, probe, rng) -> None:
    """Phase 6, K2n's run sums: probe_run_sums_grouped against its twin,
    bit-exact, in both modes (and the mode the shape picks), each call
    one K2n launch."""
    from taxor_tpu_torch.utils.u64np import fingerprint8, mix_split

    dev = torch.device("cuda")
    seed = int(rng.integers(0, 2**63))
    # S = 216 slots, the widest group's; read 0's 2,304 valid slots
    # make each warp of the smem mode flush its byte counters mid-read at
    # 512 bins
    bl, R, H = 72, 64, 2304
    pool = rng.integers(0, 2**64, 1 << 20, dtype=np.uint64)
    zero_fp = pool[fingerprint8(mix_split(pool, seed)) == 0]
    keys = rng.integers(0, 2**64, (R, H), dtype=np.uint64)
    keys[0] = zero_fp[:H]  # read 0: run sums above 256 in zero columns
    valid = rng.random((R, H)) < 0.7
    valid[0], valid[1] = True, False  # read 1: no valid slot
    hi = (keys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (hi, lo, valid)]
    kern = probe.k2n_counts
    start = dict(kern.MODES)
    n_calls = 0
    t0 = time.perf_counter()
    for G in (1, 8, 72):
        for bins in (16, 100, 512):
            Bp = probe.pad_bins(bins)
            tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
            tables[:, :, :bins] = rng.integers(0, 256, (G, 3 * bl, bins))
            tables[:, :, ::7] = 0
            tb = torch.from_numpy(tables).to(dev)
            runs = [torch.from_numpy(x).to(dev) for x in run_csr(rng, G, bins)]
            picked = probe.narrow_mode(3 * bl, Bp, dev)
            if picked != "smem":
                raise AssertionError(f"K2n run sums: [{3 * bl}, {Bp}] "
                                     f"tables take {picked}, not smem")
            for share in (0.0, 0.005, 0.6, 1.0):
                active = rng.random((G, R)) < share
                if share:
                    active[0, 0] = True  # read 0 in the run over all bins
                act = torch.from_numpy(active).to(dev)
                want = probe.probe_run_sums_grouped_plain(
                    *args, tb, act, *runs, seed, bl)
                for mode in ("smem", "rows", None):
                    n, before = kern.LAUNCHES, dict(kern.MODES)
                    got = (probe.probe_run_sums_grouped(
                        *args, tb, act, *runs, seed, bl) if mode is None
                        else probe.k2n_run_sums(*args, tb, act, *runs,
                                                seed, bl, mode=mode))
                    torch.cuda.synchronize()
                    grew = {m: c - before.get(m, 0)
                            for m, c in kern.MODES.items()
                            if c != before.get(m, 0)}
                    if kern.LAUNCHES != n + 1 or grew != {mode or picked: 1}:
                        raise AssertionError(
                            f"K2n run sums G={G} bins={bins} share={share} "
                            f"mode={mode}: {kern.LAUNCHES - n} launches, "
                            f"modes {grew}; expected one launch")
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K2n run sums ({mode or picked}) G={G} "
                            f"bins={bins} activity {share}: kernel differs "
                            "from the twin")
                    n_calls += 1
                big = int(want[0, 0])  # run 0: all of subgroup 0's bins
                if (share and big <= 256) or int(want[:, 1].abs().sum()) \
                        or (not share and int(want.abs().sum())):
                    raise AssertionError(
                        f"K2n run sums G={G} bins={bins} share={share}: "
                        "case did not exercise sums > 256 / an invalid read "
                        "/ zeros")
            log(f"K2n run sums G={G}, [{3 * bl}, {Bp}] ({bins} bins), "
                f"{runs[1].shape[0]} runs, R={R}, H={H}: bit-exact vs twin "
                f"in smem and rows mode at activity 0, 0.5%, 60% and 100% "
                f"(run over all bins {big})")
    ran = {m: c - start.get(m, 0) for m, c in kern.MODES.items()}
    # a group wider than NARROW_MAX_BINS (an IXF of more than 512 bins,
    # in a group of its own): K2's dense counts and their segment sums;
    # its own generator, so that the indexes drawn later stay as they were
    wrng = np.random.default_rng(SEED + 6)
    for G, bins in ((1, 1000), (2, 4096)):
        Bp = probe.pad_bins(bins)
        tables = np.zeros((G, 3 * bl, Bp), dtype=np.uint8)
        tables[:, :, :bins] = wrng.integers(0, 256, (G, 3 * bl, bins))
        tables[:, :, ::7] = 0
        tb = torch.from_numpy(tables).to(dev)
        runs = [torch.from_numpy(x).to(dev) for x in run_csr(wrng, G, bins)]
        active = wrng.random((G, R)) < 0.6
        active[0, 0] = True
        act = torch.from_numpy(active).to(dev)
        want = probe.probe_run_sums_grouped_plain(*args, tb, act, *runs, seed,
                                                  bl)
        n2, n = probe.k2_counts.LAUNCHES, kern.LAUNCHES
        got = probe.probe_run_sums_grouped(*args, tb, act, *runs, seed, bl)
        torch.cuda.synchronize()
        if probe.k2_counts.LAUNCHES != n2 + 1 or kern.LAUNCHES != n:
            raise AssertionError(
                f"run sums of a {bins}-bin group: {probe.k2_counts.LAUNCHES - n2}"
                f" K2 and {kern.LAUNCHES - n} K2n launches; expected one K2")
        if not torch.equal(got, want) or int(want[0, 0]) <= 256:
            raise AssertionError(f"run sums of a {bins}-bin group (K2 + "
                                 "segment sums) differ from the twin")
    log("phase 6: run sums of 1,000- and 4,096-bin groups (K2's dense "
        "counts + segment sums, one K2 launch each) bit-exact vs twin")
    log(f"phase 6: K2n run sums, {n_calls} calls of one launch each, "
        f"launches by mode {ran}, {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------- K3, K4 --
def check_sorts(torch, sort, rng) -> None:
    """K4 at four widths, and K3 on a row that breaks min_gap, from the
    main rng (the draws of the main paths that follow stay as they
    were); then, from a generator of their own, K4 at every width of
    time_sort.PAIR_WIDTHS and K3 at every emission count of
    time_sort.emission_counts, through every branch of their register
    network and both global-scratch routes."""
    from taxor_tpu_torch.tools import time_sort

    dev = torch.device("cuda")
    R = 64
    for W in (100, 128, 8192, 32768):
        hi = rng.integers(-4, 4, (R, W), dtype=np.int32)
        lo = rng.integers(-2**31, 2**31, (R, W), dtype=np.int32)
        hi[:, 1::2] = hi[:, ::2][:, :W // 2]  # every key twice
        lo[:, 1::2] = lo[:, ::2][:, :W // 2]
        hi[:, ::7] = -1  # keys equal to the all-ones sentinel
        lo[:, ::7] = -1
        args = [torch.from_numpy(x).to(dev) for x in (hi, lo)]
        assert_equal(torch, f"K4 W={W}", ("hi", "lo"),
                     sort.sort_pairs(*args), sort.sort_pairs_plain(*args))
    L, gap = 8192, 5
    kmer = torch.from_numpy(rng.integers(0, 2**62, (4, L))).to(dev)
    emit = torch.zeros((4, L), dtype=torch.bool, device=dev)
    emit[:, ::gap] = True
    emit[1, 1::gap] = True  # twice the emissions min_gap allows
    got = sort.dedup_fused(kmer, emit, 2048, gap)
    assert_equal(torch, "K3 min_gap overflow", ("kmer", "valid",
                 "n_unique", "n_emit"), got,
                 sort.dedup_fused_plain(kmer, emit, 2048, gap))
    n = (L - 1) // gap + 1
    if got[3].tolist() != [n, sort.OVERFLOW, n, n]:
        raise AssertionError(f"K3 min_gap overflow: n_emit {got[3]}")
    log(f"K3 min_gap overflow: n_emit {got[3].tolist()} (2**30 on the row "
        "that breaks the gap)")

    own = np.random.default_rng(SEED + 9)
    for W in time_sort.PAIR_WIDTHS:
        args = [torch.from_numpy(x.view(np.int32)).to(dev)
                for x in time_sort.pair_rows(own, R, W)]
        assert_equal(torch, f"K4 W={W}", ("hi", "lo"),
                     sort.sort_pairs(*args), sort.sort_pairs_plain(*args))
    log(f"K4 [{R}, W] at W = {list(time_sort.PAIR_WIDTHS)}: bit-exact vs "
        f"twin (duplicated keys, sentinel keys, a row of equal keys, a row "
        f"of sentinels; W > {sort.REG_SORT_MAX} in global scratch)")
    for L, gap in ((1000, 5), (2048, 1), (8192, 5), (16384, 5),
                   (32768, 5), (32768, 2), (32768, 1)):
        counts = time_sort.emission_counts(L, gap)
        km, em = time_sort.emission_rows(own, L, counts, gap)
        kmer = torch.from_numpy(km.view(np.int64)).to(dev)
        emit = torch.from_numpy(em).to(dev)
        for hcap in (2048, 100):
            got = sort.dedup_fused(kmer, emit, hcap, gap)
            assert_equal(torch, f"K3 L={L} min_gap={gap} hcap={hcap}",
                         ("kmer", "valid", "n_unique", "n_emit"), got,
                         sort.dedup_fused_plain(kmer, emit, hcap, gap))
        Wb = sort.dedup_width(L, gap)
        n_over = int((got[3] == sort.OVERFLOW).sum())
        if n_over != (Wb < L) or int(got[2][-2]) != 1:
            raise AssertionError(f"K3 L={L} min_gap={gap}: n_emit "
                                 f"{got[3].tolist()}, n_unique "
                                 f"{got[2].tolist()}")
        log(f"K3 L={L} min_gap={gap} (buffer {Wb}, "
            f"{'global scratch' if Wb > sort.REG_SORT_MAX else 'registers'}"
            f"): bit-exact vs twin at {counts} emissions, all-equal and "
            f"sentinel k-mers, hcap 2048 and 100")


# ------------------------------------------------------- main path data --
def make_genomes(rng, root: str, n: int, glen: int) -> tuple[str, str, list]:
    gdir = os.path.join(root, "genomes")
    os.makedirs(gdir)
    rows, genomes = [], []
    for i in range(n):
        acc = f"GCF_{i:06d}.1"
        seq = ACGT[rng.integers(0, 4, glen)].tobytes()
        genomes.append((acc, seq))
        with open(os.path.join(gdir, f"{acc}_genomic.fna"), "wb") as fh:
            fh.write(b">" + acc.encode() + b" chromosome\n" + seq + b"\n")
        rows.append(f"{acc}\t{100000 + i}\tftp://x/{acc}_genomic.fna\t"
                    f"Organism {i}\tk__Bacteria;p__P{i % 7};g__G{i % 97};"
                    f"s__Species {i}\t2;{200 + i % 7};{300 + i % 97};"
                    f"{100000 + i}")
    tsv = os.path.join(root, "taxonomy.tsv")
    with open(tsv, "w") as fh:
        fh.write("\n".join(rows) + "\n")
    return tsv, gdir, genomes


def mutate(rng, arr: np.ndarray, rate: float) -> bytes:
    n_err = rng.binomial(arr.shape[0], rate)
    pos = rng.choice(arr.shape[0], size=n_err, replace=False)
    arr[pos] = ACGT[rng.integers(0, 4, n_err)]
    return arr.tobytes()


def make_reads(rng, genomes, n_reads: int, n_long: int):
    """ONT-like reads: log-normal lengths (median 4 kb) clipped to
    500-30,000, 4% substitutions (Taxor's default --error-rate); long
    reads of 40 kb wrap around a circular genome."""
    glen = len(genomes[0][1])
    lens = np.clip(rng.lognormal(np.log(4000), 0.9, n_reads), 500,
                   min(30000, glen)).astype(int)
    recs = []
    for j, ln in enumerate(lens):
        g = int(rng.integers(0, len(genomes)))
        acc, seq = genomes[g]
        off = int(rng.integers(0, glen - ln + 1))
        arr = np.frombuffer(seq, np.uint8)[off:off + ln].copy()
        recs.append((f"read{j}_{acc}", mutate(rng, arr, 0.04)))
    for j in range(n_long):
        acc, seq = genomes[int(rng.integers(0, len(genomes)))]
        full = np.frombuffer(seq * (40000 // glen + 2), np.uint8)
        off = int(rng.integers(0, glen))
        arr = full[off:off + 40000].copy()
        recs.append((f"long{j}_{acc}", mutate(rng, arr, 0.04)))
    return recs


def write_fasta(path: str, recs) -> None:
    with open(path, "wb") as fh:
        for rid, seq in recs:
            fh.write(b">" + rid.encode() + b"\n" + seq + b"\n")


def tsv_rows(path: str, ids: set | None = None) -> list[str]:
    with open(path) as fh:
        lines = fh.read().splitlines()[1:]
    if ids is None:
        return lines
    return [x for x in lines if x.split("\t", 1)[0] in ids]


def reset_counts(extract, probe, sort, pipeline) -> None:
    from taxor_tpu_torch.device.hixf_search import ACTIVITY

    ACTIVITY.reset()
    for k in (extract.syncmer_hashes, extract.syncmer_track,
              extract.minimizer_kmers, sort.dedup_fused, sort.sort_pairs):
        k.LAUNCHES = 0
    for k in (probe.k2_counts, probe.k2n_counts):
        k.LAUNCHES = 0
        k.ROUTES = {}
    probe.k2_counts.VARIANTS = {}
    probe.k2n_counts.MODES = {}
    pipeline.ROUTES.reset()


def read_counts(extract, probe, sort) -> dict:
    return {"K1": extract.syncmer_hashes.LAUNCHES,
            "K2": probe.k2_counts.LAUNCHES, "K2n": probe.k2n_counts.LAUNCHES,
            "K2 slab": probe.k2_counts.VARIANTS.get("slab", 0),
            "K2 rows": probe.k2_counts.VARIANTS.get("rows", 0),
            "K2n smem": probe.k2n_counts.MODES.get("smem", 0),
            "K2n rows": probe.k2n_counts.MODES.get("rows", 0),
            "track": extract.syncmer_track.LAUNCHES,
            "K3": sort.dedup_fused.LAUNCHES, "K4": sort.sort_pairs.LAUNCHES,
            "K5": extract.minimizer_kmers.LAUNCHES,
            "K2 routes": dict(probe.k2_counts.ROUTES),
            "K2n routes": dict(probe.k2n_counts.ROUTES)}


def cli_build(work: str, tsv: str, gdir: str, flags: list[str],
              layout: str, label: str):
    """``cli build`` of an index with the scheme ``flags`` and --layout
    ``layout`` (--tmax TMAX for "auto") in work; returns (its file, the
    loaded index)."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.hixf.index import load_index

    idx = os.path.join(work, f"{label}.taxor.npz")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)  # the build writes its layout file (binning.out) here
    try:
        rc = cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                       gdir, "--output-filename", idx, *flags, "--layout",
                       layout, "--threads", str(os.cpu_count() or 1)]
                      + (["--tmax", str(TMAX)] if layout == "auto" else []))
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"[{label}] build failed ({rc})")
    index = load_index(idx)
    ixfs = index.hixf.ixfs
    log(f"[{label}] build: {time.perf_counter() - t0:.1f} s, {len(ixfs)} "
        f"IXF(s), root S={ixfs[0].fingerprints.shape[0]} x "
        f"B={ixfs[0].fingerprints.shape[1]} (block_length "
        f"{ixfs[0].block_length}), fingerprints "
        f"{sum(x.fingerprints.nbytes for x in ixfs) / 1e6:.1f} MB")
    return idx, index


def device_search(torch, idx: str, reads: str, out: str, label: str,
                  modules) -> tuple[dict, dict, float, float]:
    """``cli search --engine device`` with every launch count set to 0
    just before and read just after; (launches, routes, wall s, peak
    device MiB)."""
    from taxor_tpu_torch import cli

    reset_counts(*modules)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", reads,
                   "--output-file", out, "--engine", "device",
                   "--device", "cuda", "--write-time", "--threads",
                   str(os.cpu_count() or 1)])
    wall = time.perf_counter() - t0
    launches = read_counts(*modules[:3])
    routes = dict(modules[3].ROUTES.counts)
    if rc != 0:
        raise RuntimeError(f"[{label}] device search failed ({rc})")
    return launches, routes, wall, torch.cuda.max_memory_allocated() / 2**20


def host_parity(work: str, idx: str, recs, n_reads: int, out_dev: str,
                label: str) -> tuple[set, list]:
    """The device TSV equals ``--engine host`` byte for byte on the first
    CHECK_READS reads and the long ones; returns (their ids, the host
    rows)."""
    from taxor_tpu_torch import cli

    sub = recs[:min(CHECK_READS, n_reads)] + recs[n_reads:]
    sub_fa = os.path.join(work, f"{label}_subset.fasta")
    write_fasta(sub_fa, sub)
    out_host = os.path.join(work, f"{label}_host.tsv")
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", sub_fa,
                   "--output-file", out_host, "--engine", "host",
                   "--device", "cuda", "--threads",
                   str(os.cpu_count() or 1)])
    if rc != 0:
        raise RuntimeError(f"[{label}] host search failed ({rc})")
    ids = {rid for rid, _ in sub}
    dev_rows, host_rows = tsv_rows(out_dev, ids), tsv_rows(out_host)
    if dev_rows != host_rows:
        bad = next(i for i, (a, b) in enumerate(zip(dev_rows, host_rows))
                   if a != b) if len(dev_rows) == len(host_rows) else -1
        raise AssertionError(f"[{label}] device TSV differs from host TSV "
                             f"(row {bad}, {len(dev_rows)} vs "
                             f"{len(host_rows)} rows)")
    log(f"[{label}] parity: device TSV == host TSV byte for byte on "
        f"{len(sub)} reads ({len(host_rows)} rows; host engine "
        f"{time.perf_counter() - t0:.1f} s)")
    return ids, host_rows


def accuracy(out_dev: str, recs) -> tuple[int, int]:
    """(classified reads, those whose first row names their source
    genome)."""
    first = {}
    for row in tsv_rows(out_dev):
        rid, acc = row.split("\t", 2)[:2]
        first.setdefault(rid, acc)
    hits = [rid for rid, _ in recs if first.get(rid, "-") != "-"]
    return len(hits), sum(first[rid] == rid.split("_", 1)[1] for rid in hits)


def main_path(torch, work: str, rng, n_genomes: int, n_reads: int,
              layout: str) -> dict:
    """Build an index of n_genomes with --layout ``layout``, search
    n_reads + LONG_READS through the device engine with the launch
    counts set to 0 just before, check the TSV against --engine host on
    a subset and the classifications against the source genomes."""
    from taxor_tpu_torch.device import e2e, extract, probe, sort
    from taxor_tpu_torch.search import pipeline

    modules = (extract, probe, sort, pipeline)
    t0 = time.perf_counter()
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    recs = make_reads(rng, genomes, n_reads, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    log(f"[{layout}] data: {n_genomes} genomes x {GENOME_LEN} b, {n_reads} "
        f"reads ({sum(len(s) for _, s in recs[:n_reads]) / 1e6:.1f} Mb) + "
        f"{LONG_READS} x 40 kb, made in {time.perf_counter() - t0:.1f} s")
    idx, index = cli_build(work, tsv, gdir,
                           ["--kmer-size", str(K), "--syncmer-size", str(S),
                            "--use-syncmer"], layout, layout)

    # ---- the main path, counted
    out_dev = os.path.join(work, "device.tsv")
    launches, routes, wall, peak = device_search(torch, idx, reads, out_dev,
                                                 layout, modules)
    if launches["K1"] <= 0 or launches["K2"] + launches["K2n"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if layout == "flat" and launches["K2 slab"] <= 0:
        raise AssertionError(f"the flat path did not take K2's slab route: "
                             f"{launches}")
    if layout == "auto" and (launches["K2n smem"] <= 0
                             or launches["K2n rows"] <= 0):
        raise AssertionError(f"the hierarchical path did not run both K2n "
                             f"modes: {launches}")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    n_total = len(recs)
    log(f"[{layout}] main path: {n_total} reads in {wall:.2f} s wall = "
        f"{n_total / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes} (host-oracle fallback "
        f"{routes['host_fallback'] / n_total:.4f}); peak device memory "
        f"{peak:.1f} MiB")

    # ---- byte parity with the host engine on a subset
    ids, host_rows = host_parity(work, idx, recs, n_reads, out_dev, layout)

    # ---- the split engine on the same reads, counted
    out_split = os.path.join(work, "split.tsv")
    e2e.USE_FUSED_EXTRACT = False
    try:
        split, split_routes, wall_split, split_peak = device_search(
            torch, idx, reads, out_split, layout, modules)
    finally:
        e2e.USE_FUSED_EXTRACT = True
    if split["K1"] != 0 or split["track"] <= 0 or split["K3"] <= 0:
        raise AssertionError(f"split engine: wrong kernels launched {split}")
    with open(out_dev, "rb") as fa, open(out_split, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("split-engine TSV differs from the K1 TSV")
    if tsv_rows(out_split, ids) != host_rows:
        raise AssertionError("split-engine TSV differs from the host TSV")
    log(f"[{layout}] split engine: {n_total} reads in {wall_split:.2f} s "
        f"wall = {n_total / wall_split:.1f} reads/s; TSV == K1 TSV on every "
        f"read and == host on {len(ids)}; launches {split}; routes "
        f"{split_routes}; peak device memory {split_peak:.1f} MiB")

    # ---- the result is right: a classified read names its source genome
    hits, right = accuracy(out_dev, recs)
    if right < 0.99 * hits:
        raise AssertionError(f"only {right} of {hits} classified reads "
                             "name their source genome")
    log(f"[{layout}] accuracy: {hits}/{n_total} reads classified, "
        f"{right} of them to their source genome")
    return {"index": index, "recs": recs, "launches": launches,
            "split": split, "routes": routes, "peak_mib": peak,
            "split_peak_mib": split_peak, "tsv": tsv, "gdir": gdir,
            "reads": reads, "n_reads": n_reads, "idx": idx,
            "device_tsv": out_dev}


def hier_report(torch, state) -> None:
    """The hierarchical path's shape and descent activity; asserts a
    hierarchy with a stacked group, the grouped probe and the per-IXF
    traversal."""
    from taxor_tpu_torch.device import hixf_search

    dh = hixf_search.DeviceHIXF.from_hixf(state["index"].hixf, "cuda")
    Gs = [g["tables"].shape[0] for g in dh.groups]
    depth = max(dh._depths().values())
    launches = state["launches"]
    counts_route = (launches["K2 routes"].get("host_hashes", 0)
                    + launches["K2n routes"].get("host_hashes", 0))
    log(f"[auto] tree: {len(dh.ixfs)} IXFs, depth {depth}; {sum(Gs)} probe "
        f"subgroups in {len(Gs)} launches per batch, stacked groups G="
        f"{[G for G in Gs if G > 1]}, tables "
        f"{[tuple(g['tables'].shape) for g in dh.groups]}; active "
        f"(subgroup, read) pairs {hixf_search.ACTIVITY.share():.4f}; "
        f"probe launches on the per-IXF traversal {counts_route}")
    if len(dh.ixfs) <= 1 or max(Gs) < 2:
        raise AssertionError("the hierarchical cell has no hierarchy or no "
                             "stacked group")
    from taxor_tpu_torch.device import probe

    modes = [probe.narrow_mode(*g["tables"].shape[1:], "cuda")
             for g in dh.groups]
    log(f"[auto] K2n mode of each group: "
        f"{[(tuple(g['tables'].shape), int(g['run_s'].shape[0]), m) for g, m in zip(dh.groups, modes)]}"
        f" (shape, runs, mode); main-path launches by mode: smem "
        f"{launches['K2n smem']}, rows {launches['K2n rows']}")
    if modes[0] != "rows" or not any(
            m == "smem" for G, m in zip(Gs, modes) if G > 1):
        raise AssertionError(f"K2n modes: root {modes[0]}, stacked groups "
                             f"{modes[1:]}; expected rows on the root and "
                             "smem on a stacked group")
    fused = (launches["K2 routes"].get("fused", 0)
             + launches["K2n routes"].get("fused", 0))
    if fused <= 0 or counts_route <= 0 or state["routes"]["host_hashes"] <= 0:
        raise AssertionError(f"a route skipped the probe: {launches}")
    state["dh"] = dh


def check_wide_root(torch, work: str) -> None:
    """Phase 7b: a hierarchical index whose root has 529 technical bins
    (a hand-written layout over 540 genomes of 600 b, as a build at the
    default --tmax gives roots past 512 bins): its descent group takes
    K2's dense counts and their segment sums on the card, in the grouped
    step and in the per-IXF traversal, equal to the CPU twins."""
    from taxor_tpu_torch.apps.build import BuildConfig, run_build
    from taxor_tpu_torch.device import probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hash.schemes import search_hashes
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.tools import synth

    rng = np.random.default_rng(SEED + 7)
    os.makedirs(work)
    tsv, gdir, genomes = synth.make_ref_set(work, rng, n_species=540,
                                            genome_len=600)
    files = [os.path.join(gdir, f"{acc}_genomic.fna") for acc in genomes]
    layout = os.path.join(work, "wide.out")
    root_bins = synth.write_wide_root_layout(files, layout)
    index = run_build(BuildConfig(
        input_file=tsv, input_sequence_dir=gdir, output_filename="",
        kmer_size=K, syncmer_size=S, use_syncmer=True, layout_file=layout,
        resume=True))
    seqs = list(genomes.values())
    reads = [synth.simulate_read(rng, seqs[i], 400, 0.02)
             for i in [0, 1, *range(520, 540), *rng.integers(1, 520, 100)]]
    packed, lengths = dsync.pack_reads(reads, 512)
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    dhs = [DeviceHIXF.from_hixf(index.hixf, d) for d in ("cpu", "cuda")]
    shapes = [tuple(g["tables"].shape) for g in dhs[1].groups]
    if shapes[0][2] <= probe.NARROW_MAX_BINS:
        raise AssertionError(f"wide root: groups {shapes}")
    before = dict(probe.k2_counts.ROUTES)
    out = [dh.e2e_async(packed, lengths, index.scheme, th)() for dh in dhs]
    for a, b in zip(out[0][:4], out[1][:4]):
        if not np.array_equal(a, b):
            raise AssertionError("wide root: the grouped step on the card "
                                 "differs from the CPU twins")
    hl = search_hashes(reads, index.scheme)
    thr = np.array([th.get(h.shape[0], 0.0) for h in hl], dtype=np.int64)
    hi, lo, valid = probe.pack_hash_lists(hl, max(h.shape[0] for h in hl))
    dense = [dh.counts(hi, lo, valid, thr) for dh in dhs]
    if not all(np.array_equal(a, b) for a, b in zip(*dense)):
        raise AssertionError("wide root: the per-IXF traversal on the card "
                             "differs from the CPU twins")
    grew = {r: n - before.get(r, 0) for r, n in probe.k2_counts.ROUTES.items()}
    if grew.get("fused") != 1 or grew.get("host_hashes") != 1 \
            or not (out[1][0][:, 0] > 0).all():
        raise AssertionError(f"wide root: K2 launches by route {grew}")
    log(f"phase 7b: a {root_bins}-bin root (groups {shapes}): {len(reads)} "
        f"reads, grouped step and per-IXF traversal on K2 + segment sums "
        f"equal to the CPU twins")


def time_pair(torch, fn, plain, reps: int):
    """(kernel ms, plain ms, max abs err), each the best of two means,
    timed plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, 1)
    m1 = cuda_ms(fn, reps)
    m2 = cuda_ms(fn, reps)
    p2 = cuda_ms(plain, 1)
    got, want = fn(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
              for a, b in zip(got, want))
    if err != 0.0:
        raise AssertionError("a kernel differs from its twin")
    return min(m1, m2), min(p1, p2), err, (m1, m2, p1, p2)


def bound(nbytes: float, ops: float, peak: float) -> dict:
    """The least time the card could take: the larger of nbytes over the
    memory rate and ops over the peak rate of their type."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / peak * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def tracker_ops(k: int, s: int) -> int:
    """Integer operations a base of the position-parallel tracker
    (csrc/tracker.cuh) takes: ~12 for the canonical s-mer (a funnel
    shift, a bit reversal and a pair swap, the complement, the min), 4 a
    window element for the scan (two compares, the minimum and an argmin
    selected), ~6 to classify the window and ballot it: 62 at w = 11."""
    return 12 + 4 * (k - s + 1) + 6


# a canonical k-mer: two funnel shifts, two 2-bit reversals and their
# 64-bit shift, the complement and mask, the min
KMER_OPS = 14


def sort_ops(n) -> float:
    """Compare-exchanges of bitonic networks over pow2(n) keys, per row."""
    P = [1 << max(0, x - 1).bit_length() for x in n]
    return float(sum(p // 2 * (p.bit_length() - 1) * p.bit_length() // 2
                     for p in P))


def bucket_reads(recs, L: int) -> list[bytes]:
    """POS_BUDGET / L reads of the L bucket, as the pipeline batches them."""
    from taxor_tpu_torch.search.pipeline import POS_BUDGET

    seqs = [s for _, s in recs if L // 2 < len(s) <= L]
    n = POS_BUDGET // L
    return (seqs * (n // max(1, len(seqs)) + 1))[:n]


def time_kernels(torch, state) -> list[dict]:
    """K1 and K2 against their twins at the flat path's L=8192 bucket."""
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    dev = torch.device("cuda")
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    hcap = dsync.hash_cap(L)
    t = (K - S + 1) // 2
    dh = DeviceHIXF.from_hixf(state["index"].hixf, dev)
    k1 = lambda: extract.syncmer_hashes(pk, ln, K, S, t, hcap)  # noqa: E731
    k1p = lambda: extract.syncmer_hashes_plain(pk, ln, K, S, t,  # noqa: E731
                                               hcap)
    hi, lo, valid, _, n_emit = k1()
    R, H = hi.shape
    S_, Bp = dh.table.shape
    W = extract.sort_width(L, K, S, t)
    bounds = {
        # packed + lengths in; hi, lo, valid, n_unique, n_emit out; the
        # tracker's operations a base, a k-mer an emission, the sort
        # network, one hash a slot
        "syncmer_extract": bound(
            pk.numel() + 4 * R + 9 * R * H + 8 * R,
            float(ln.sum()) * tracker_ops(K, S)
            + float(n_emit.sum()) * KMER_OPS
            + sort_ops(n_emit.clamp(max=W).tolist()) + R * H,
            PEAK_SCALAR),
        # hashes in, the table once, counts out; one fingerprint-byte
        # compare per valid hash and bin (either variant of K2)
        "probe_count": bound(9 * R * H + S_ * Bp + 4 * R * Bp,
                             float(valid.sum()) * Bp, PEAK_INT8)}
    bounds["probe_count_rows"] = bounds["probe_count"]
    tables = dh.table[None]
    k2 = lambda: probe.probe_counts(hi, lo, valid, dh.table,  # noqa: E731
                                    dh.seed, dh.block_length)
    k2r = lambda: probe.k2_counts(hi, lo, valid, tables, None,  # noqa: E731
                                  dh.seed, dh.block_length,
                                  variant="rows")[0]
    k2p = lambda: probe.probe_counts_plain(hi, lo, valid,  # noqa: E731
                                           dh.table, dh.seed,
                                           dh.block_length)
    n_valid = int(valid.sum())
    row_bytes = 3 * n_valid * Bp  # the table rows the probe reads
    rows = []
    for name, src, rep, fn, plain, reps in (
            ("syncmer_extract", "taxor_tpu_torch/csrc/extract.cu",
             "taxor_tpu/device/pallas_extract.py:160", k1, k1p, 5),
            ("probe_count", "taxor_tpu_torch/csrc/probe_slab.cu",
             "taxor_tpu/device/pallas_probe.py:257", k2, k2p, 20),
            ("probe_count_rows", "taxor_tpu_torch/csrc/probe.cu",
             "taxor_tpu/device/pallas_probe.py:257", k2r, k2p, 20)):
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        log(f"time {name} at R={len(seqs)}, L={L}, H={hcap}, table "
            f"{tuple(dh.table.shape)}: kernel {each[0]:.4f}/{each[1]:.4f} "
            f"ms, plain {each[2]:.3f}/{each[3]:.3f} ms")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bounds[name],
                     "library_ms": None})
        if name.startswith("probe_count"):
            rows[-1].update(valid_hashes=n_valid, row_bytes=row_bytes,
                            rows_gbps=row_bytes / ms / 1e6)
    rows[1]["slab_bins"] = probe.slab_bins(S_, Bp, dev)
    log(f"time K2 at the flat table [{S_}, {Bp}]: {n_valid} valid hashes "
        f"({n_valid / R:.1f} a read), {row_bytes / 1e9:.3f} GB of rows; slab "
        f"route ({rows[1]['slab_bins']} bins a slab) {rows[1]['ms']:.4f} ms "
        f"= {rows[1]['rows_gbps']:.1f} GB/s of rows from shared memory; rows "
        f"route {rows[2]['ms']:.4f} ms = {rows[2]['rows_gbps']:.1f} GB/s "
        f"from L2; bound {rows[1]['bound_ms']:.4f} ms "
        f"({rows[1]['bound_by']})")
    state["k1_ms"] = rows[0]["ms"]

    # the worst case: every window of every read tied
    tied = all_tied_reads(np.random.default_rng(SEED + 5), L, len(seqs))
    tpk, tln = (torch.from_numpy(x).to(dev)
                for x in dsync.pack_reads(tied, L))
    state["all_tied"] = (tpk, tln)
    worst, _, _, each = time_pair(
        torch, lambda: extract.syncmer_hashes(tpk, tln, K, S, t, hcap),
        lambda: extract.syncmer_hashes_plain(tpk, tln, K, S, t, hcap), 3)
    rows[0]["all_tied_ms"] = worst
    log(f"time syncmer_extract worst case, R={len(tied)} reads tied in "
        f"every window (homopolymers, tandem repeats of period 2-5) at "
        f"L={L}: kernel {each[0]:.4f}/{each[1]:.4f} ms "
        f"({worst / rows[0]['ms']:.1f}x the flat path's reads), plain "
        f"{each[2]:.3f}/{each[3]:.3f} ms; bit-exact vs twin")
    return rows


def time_split(torch, state) -> list[dict]:
    """K3 against the pair-sort route (K4) on the flat path's L=8192
    reads; then syncmer_track, K3 and K4 timed against their twins, K4
    against torch.sort of the combined key, and the split engine's
    extraction against K1 (phase 10)."""
    from taxor_tpu_torch.device import extract, sort
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_sort import device_ms
    from taxor_tpu_torch.utils.u64 import INT64_MIN, join32, split32

    dev = torch.device("cuda")
    L = 8192
    t = (K - S + 1) // 2
    gap = dsync.emission_min_gap(K, S, t)
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    hcap = dsync.hash_cap(L)
    R = len(seqs)
    kmer, emit = extract.syncmer_track(pk, ln, K, S, t)
    fused = sort.dedup_fused(kmer, emit, hcap, gap)
    sort.sort_pairs.LAUNCHES = 0
    pairs = sort.dedup_pairs(kmer, emit, hcap)
    state["k4_check"] = sort.sort_pairs.LAUNCHES
    assert_equal(torch, "K3 vs the pair-sort route", ("kmer", "valid",
                 "n_unique", "n_emit"), fused, pairs)
    if state["k4_check"] != 1:
        raise AssertionError(f"dedup_pairs launched K4 {state['k4_check']} "
                             "times, not once")
    log(f"K3 == sort.dedup_pairs (K4 over [{R}, {L}]) on the flat path's "
        f"L={L} reads")

    hi, lo = split32(torch.where(emit, kmer, torch.full_like(kmer, -1)))
    keys = join32(hi, lo) ^ INT64_MIN
    n_emit = fused[3]
    Wb = sort.dedup_width(L, gap)
    # the k-mers K3 needs: the first Wb emissions of a row, as the
    # 32-byte sectors (the memory's least transfer) that hold one,
    # counted from this batch
    needed = emit & (emit.cumsum(1) <= Wb)
    sectors = float(needed.view(R, L // 4, 4).any(2).sum())
    Wp = L
    cases = (
        ("syncmer_track", "taxor_tpu_torch/csrc/extract.cu",
         "taxor_tpu/hash/device_syncmer.py:279 (XLA scan, no Pallas "
         "kernel)", lambda: extract.syncmer_track(pk, ln, K, S, t),
         lambda: dsync.syncmer_kmers(pk, ln, K, S, t), None, 5,
         # packed + lengths in, kmer + emit out; the tracker's operations
         # a base and a k-mer a position
         bound(pk.numel() + 4 * R + 9 * R * L,
               float(ln.sum()) * tracker_ops(K, S) + R * L * KMER_OPS,
               PEAK_SCALAR)),
        ("dedup", "taxor_tpu_torch/csrc/dedup.cu",
         "taxor_tpu/device/pallas_sort.py:68",
         lambda: sort.dedup_fused(kmer, emit, hcap, gap),
         lambda: sort.dedup_fused_plain(kmer, emit, hcap, gap), None, 20,
         # emit read whole and the needed k-mers' sectors in; kmer,
         # valid, counts out; a scan of the row and the sort network over
         # the emissions
         bound(R * L + 32 * sectors + 9 * R * hcap + 8 * R,
               R * L + sort_ops(n_emit.clamp(max=Wb).tolist()),
               PEAK_SCALAR)),
        ("sort_pairs", "taxor_tpu_torch/csrc/sort_pairs.cu",
         "taxor_tpu/device/pallas_sort.py:62",
         lambda: sort.sort_pairs(hi, lo),
         lambda: sort.sort_pairs_plain(hi, lo),
         lambda: torch.sort(keys, dim=1), 20,
         bound(16 * R * L, sort_ops([Wp] * R), PEAK_SCALAR)))
    rows = []
    for name, src, rep, fn, plain, library, reps, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        lib_ms = None if library is None else cuda_ms(library, reps)
        log(f"time {name} at R={R}, L={L}, hcap={hcap}: kernel "
            f"{each[0]:.4f}/{each[1]:.4f} ms, plain {each[2]:.3f}/"
            f"{each[3]:.3f} ms, library {lib_ms}, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": lib_ms})
        if name != "syncmer_track":  # K3, K4: the kernel alone, host gaps out
            rows[-1]["device_ms"] = device_ms(fn, reps, rounds=1)
            log(f"time {name} on the device alone: "
                f"{rows[-1]['device_ms']:.4f} ms")

    tpk, tln = state["all_tied"]
    assert_equal(torch, "syncmer_track on reads tied everywhere",
                 ("kmer", "emit"), extract.syncmer_track(tpk, tln, K, S, t),
                 dsync.syncmer_kmers(tpk, tln, K, S, t))
    rows[0]["all_tied_ms"] = cuda_ms(
        lambda: extract.syncmer_track(tpk, tln, K, S, t), 3)
    log(f"time syncmer_track worst case (phase 5's {tpk.shape[0]} reads "
        f"tied everywhere) at L={L}: {rows[0]['all_tied_ms']:.4f} ms; "
        "bit-exact vs twin")

    def split_extract():
        km, em = extract.syncmer_track(pk, ln, K, S, t)
        srt, valid, _, _ = sort.dedup_fused(km, em, hcap, gap)
        return extract.hashes_of_kmers(srt, valid)

    split_ms = cuda_ms(split_extract, 5)
    log(f"time split extraction (syncmer_track + K3 + wyhash) at R={R}, "
        f"L={L}: {split_ms:.4f} ms vs K1 {state['k1_ms']:.4f} ms")
    return rows


def narrow_bound(hi, valid, tables, act, n_runs: int) -> dict:
    """K2n's least time for one run-sum launch: the hashes (9 bytes a
    slot) of the reads with an active pair and the mask read once, the
    tables of the subgroups with an active read, the [n_runs, R] sums
    written once; one fingerprint-byte compare per valid hash of an
    active (subgroup, read) pair and bin."""
    G, S_, Bp = tables.shape
    R, H = hi.shape
    active_hashes = float((act.long() * valid.sum(1)[None]).sum())
    reads = int(act.any(0).sum())
    loaded = int(act.any(1).sum())
    return bound(9 * reads * H + G * R + loaded * S_ * Bp + 4 * n_runs * R,
                 active_hashes * Bp, PEAK_INT8)


def time_hier(torch, state) -> list[dict]:
    """Phase 8: every group of one descent batch at the hierarchical
    path's L=8192 and L=4096 buckets, with the descent's own activity
    masks: (a) the dense K2n counts and their int64 segment sums against
    (b) the run-sum launch, timed a, b, b, a by cuda_ms and again by
    device_ms, both bit-exact to the twin;
    K2n's record (the root and the widest group at L=8192, against the
    twin) and K2 (the variant each shape picks) on the root and the first
    stacked level."""
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.e2e import descend
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_sort import device_ms

    dev = torch.device("cuda")
    dh = state["dh"]
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    stacked = next(i for i, g in enumerate(dh.groups)
                   if g["tables"].shape[0] > 1)
    widest = max(range(len(dh.groups)),
                 key=lambda i: dh.groups[i]["tables"].shape[0])
    per_group, record = [], None
    for L in (8192, 4096):
        seqs = bucket_reads(state["recs"], L)
        packed, lengths = dsync.pack_reads(seqs, L)
        hcap = dsync.hash_cap(L)
        hi, lo, valid, n_unique, _ = extract.syncmer_hashes(
            torch.from_numpy(packed).to(dev),
            torch.from_numpy(lengths).to(dev), K, S, (K - S + 1) // 2, hcap)
        thr = torch.from_numpy(dh._thr_table(th, hcap)).to(dev)[
            n_unique.clamp(0, hcap).long()]
        R = hi.shape[0]
        for gi, g in enumerate(dh.groups):
            act = descend(dh.groups, len(dh.bfs_order), hi, lo, valid, thr,
                          upto=gi)
            tables = g["tables"]
            runs = (g["run_off"], g["run_s"], g["run_e"])
            run_g = probe.run_groups(g["run_off"])
            a = (hi, lo, valid, tables, act)
            sk = (g["seed"], g["bl"])
            dense = lambda: probe.segment_sums(  # noqa: E731
                probe.k2n_counts(*a, *sk), run_g, g["run_s"], g["run_e"])
            fused = lambda: probe.probe_run_sums_grouped(  # noqa: E731
                *a, *runs, *sk)
            plain = lambda: probe.probe_run_sums_grouped_plain(  # noqa: E731
                *a, *runs, *sk)
            want = plain()
            assert_equal(torch, f"group {gi} at L={L}", ("dense", "fused"),
                         (dense(), fused()), (want, want))
            a1, b1 = cuda_ms(dense, 10), cuda_ms(fused, 20)
            b2, a2 = cuda_ms(fused, 20), cuda_ms(dense, 10)
            da1, db1 = device_ms(dense, 10, 1), device_ms(fused, 20, 1)
            db2, da2 = device_ms(fused, 20, 1), device_ms(dense, 10, 1)
            n_runs = int(g["run_s"].shape[0])
            row = {"L": L, "R": R, "shape": list(tables.shape),
                   "active_pairs": int(act.sum()), "pairs": act.numel(),
                   "n_runs": n_runs,
                   "mode": probe.narrow_mode(*tables.shape[1:], dev),
                   "dense_ms": min(a1, a2), "ms": min(b1, b2),
                   "dense_device_ms": min(da1, da2),
                   "device_ms": min(db1, db2),
                   **narrow_bound(hi, valid, tables, act, n_runs)}
            per_group.append(row)
            log(f"time group {gi} at L={L}, R={R}: tables "
                f"{tuple(tables.shape)}, {row['active_pairs']}/"
                f"{row['pairs']} (subgroup, read) pairs active, {n_runs} "
                f"runs, K2n mode {row['mode']}: (a) dense counts + segment "
                f"sums {a1:.4f}/{a2:.4f} ms, (b) run sums {b1:.4f}/{b2:.4f} "
                f"ms; on the device alone (a) {da1:.4f}/{da2:.4f} ms, (b) "
                f"{db1:.4f}/{db2:.4f} ms; bound of (b) {row['bound_ms']:.4f} "
                f"ms ({row['bound_by']})")
            if L != 8192:
                continue
            if gi in (0, widest):
                ms, plain_ms, err, each = time_pair(torch, fused, plain, 20)
                log(f"time probe_count_narrow (run sums) on group {gi} at "
                    f"L={L}: kernel {each[0]:.4f}/{each[1]:.4f} ms, plain "
                    f"{each[2]:.3f}/{each[3]:.3f} ms")
                if gi == 0:
                    record = {
                        "name": "probe_count_narrow", "route": "cuda",
                        "source": "taxor_tpu_torch/csrc/probe_narrow.cu",
                        "replaces": "taxor_tpu/device/pallas_probe.py:578",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        **narrow_bound(hi, valid, tables, act, n_runs),
                        "library_ms": None, "shape": list(tables.shape),
                        "mode": row["mode"]}
                else:
                    record.update(
                        widest_shape=list(tables.shape), widest_ms=ms,
                        widest_plain_ms=plain_ms, widest_mode=row["mode"],
                        widest_bound_ms=row["bound_ms"],
                        widest_bound_by=row["bound_by"],
                        max_abs_err=max(record["max_abs_err"], err))
            if gi in (0, stacked):
                b = probe.slab_bins(*tables.shape[1:], dev)
                ms, _, _, each = time_pair(
                    torch, lambda: probe.k2_counts(*a, *sk),  # noqa: B023
                    lambda: probe.probe_counts_grouped_plain(  # noqa: B023
                        *a, *sk), 20)
                log(f"time probe_count ({f'slab of {b} bins' if b else 'rows'}"
                    f") dense counts on group {gi} at L={L}: kernel "
                    f"{each[0]:.4f}/{each[1]:.4f} ms")
    record["groups"] = per_group
    return [record]


# ------------------------------------------------------------ phase 13 --
# the bench's hier_scaled_minimizer family's scheme (phases 13a and 13e)
MM_K, MM_WINDOW, MM_SCALING = 20, 26, 3
K5_SCHEMES = ((20, 20), (20, 26), (18, 26), (32, 40))  # (k, window)
K5_SCALINGS = (2, 3, 1000)  # phase 13c's FracMinHash keeps
BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# the keep of one emission: wyhash64's 64 x 64 -> 128-bit multiply (seven
# 32-bit multiply-adds), the XOR of its halves and the 64-bit compare
KEEP_OPS = 11


def k5_ops(k: int, window: int) -> int:
    """Integer operations a position of K5 takes before the keep: ~16 for
    the canonical value (funnel shifts of the aligned words and their
    2-bit reversal, the complement and mask, the 64-bit shift, two XORs
    with the seed, the 64-bit minimum); for w' > 1 the window pass, w' + 8
    64-bit minima a thread's run of four positions (window_split: w' - 4
    over the values left of the run, 3 taking in the three oldest, 2
    prefix minima of its own values, 3 merging them, and the four
    emitted minima), 4 operations each, so w' + 8 a position, and ~8 for
    the emission test: 39 at w' = 7, 16 at w' = 1."""
    wp = window - k + 1
    return 16 if wp == 1 else 16 + (wp + 8) + 8


def check_k5(torch, dsync, extract, rng) -> None:
    """Phase 13c: K5 against its twin, bit for bit (0 where nothing is
    emitted), at every length bucket on phase 2's kinds of reads, for each
    (k, window) of K5_SCHEMES: plain k-mers (w' = 1), windowed minimisers
    and k = 32 (the seed's top bit set); without the FracMinHash keep
    (valid = emit, n_unique = n_emit) and with it for each scaling of
    K5_SCALINGS (the twin followed by the keep as tensor ops)."""
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    names = ("hi", "lo", "valid", "n_emit", "n_unique")
    for L in BUCKETS:
        packed, lengths = dsync.pack_reads(k1_reads(rng, L), L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        n_emit, kept = [], []
        for k, window in K5_SCHEMES:
            hi, lo, emit, ne = dsync.minimizer_kmers_plain(pk, ln, k, window)
            assert_equal(torch, f"K5 L={L} k={k} window={window}", names,
                         extract.minimizer_kmers(pk, ln, k, window),
                         (hi, lo, emit, ne, ne))
            n_emit.append(int(ne.sum()))
            for sc in K5_SCALINGS:
                thresh = scaling_threshold_u64(sc)
                valid = emit & extract.scaling_keep(hi, lo, thresh)
                nu = valid.sum(dim=1, dtype=torch.int32)
                assert_equal(torch, f"K5 L={L} k={k} window={window} "
                             f"scaling {sc}", names,
                             extract.minimizer_kmers(pk, ln, k, window,
                                                     thresh),
                             (hi, lo, valid, ne, nu))
                kept.append(int(nu.sum()))
        log(f"K5 L={L}: bit-exact vs twin on {pk.shape[0]} reads for (k, "
            f"window) {list(K5_SCHEMES)}, with no keep and the keeps of "
            f"scalings {list(K5_SCALINGS)} (emissions {n_emit}; kept by "
            f"scheme and scaling {kept})")
    log(f"phase 13c: K5 checked in {time.perf_counter() - t0:.1f} s")


def kmer_data(rng, work: str, n_genomes: int, n_reads: int) -> dict:
    """Phase 13b's data: n_genomes genomes of phase 7's kind and n_reads
    reads of its recipe plus LONG_READS over L_CAP."""
    os.makedirs(work)
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    recs = make_reads(rng, genomes, n_reads, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    return {"tsv": tsv, "gdir": gdir, "reads": reads, "recs": recs,
            "n_reads": n_reads}


def nonsyncmer_path(torch, work: str, label: str, data: dict, flags,
                    layout: str, need) -> dict:
    """Phase 13a/13b: ``cli build`` of a minimiser or plain k-mer index on
    ``data``'s genomes, ``cli search --engine device`` of its reads with
    the launch counts set to 0 just before and read just after; the
    kernels ``need`` must have launched, every read up to L_CAP must take
    the fused step and only the reads over it the host-hash route, and
    the TSV must equal ``--engine host`` on the first CHECK_READS reads
    and the long ones.  The share of classified reads that name their
    source genome is logged, not gated."""
    from taxor_tpu_torch.device import extract, probe, sort
    from taxor_tpu_torch.device.hixf_search import ACTIVITY
    from taxor_tpu_torch.search import pipeline

    recs, n_reads = data["recs"], data["n_reads"]
    idx, index = cli_build(work, data["tsv"], data["gdir"], flags, layout,
                           label)
    out_dev = os.path.join(work, f"{label}_device.tsv")
    launches, routes, wall, peak = device_search(
        torch, idx, data["reads"], out_dev, label,
        (extract, probe, sort, pipeline))
    active = ACTIVITY.share()
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"[{label}] the path skipped one of {need}: "
                             f"{launches}")
    if routes["fused"] != n_reads or routes["host_hashes"] != len(recs) \
            - n_reads:
        raise AssertionError(f"[{label}] routes {routes}: expected every "
                             f"read up to L_CAP fused")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    log(f"[{label}] main path: {len(recs)} reads in {wall:.2f} s wall = "
        f"{len(recs) / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes}; active (subgroup, read) pairs "
        f"{active:.4f}; peak device memory {peak:.1f} MiB")
    host_parity(work, idx, recs, n_reads, out_dev, label)
    hits, right = accuracy(out_dev, recs)
    log(f"[{label}] accuracy (reported, not gated): {hits}/{len(recs)} "
        f"reads classified, {right} of them ({right / max(1, hits):.4f}) to "
        f"their source genome")
    return {"index": index, "recs": recs, "launches": launches,
            "routes": routes, "peak_mib": peak, "wall": wall,
            "active_share": active, "idx": idx, "device_tsv": out_dev,
            "reads": data["reads"]}


def time_k5(torch, state) -> dict:
    """Phase 13d: K5 against its twin at the minimiser path's L=8192
    bucket (R=512), a call and on the device alone, for the path's scheme
    with no keep, for plain k-mers and for the path's scheme with its
    FracMinHash keep (scaling MM_SCALING), through
    ``tools.time_minimizer.measure``; then the keep as tensor ops on K5's
    output (``time_keep``), the reference for the scaled times."""
    from taxor_tpu_torch.device import extract
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.hash.schemes import scaling_threshold_u64
    from taxor_tpu_torch.tools import time_minimizer as tm

    dev = torch.device("cuda")
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    R = pk.shape[0]
    if (tm.K, tm.CASES) != (MM_K, (("w7", MM_WINDOW, 1), ("w1", MM_K, 1),
                                   ("w7_scaled", MM_WINDOW, MM_SCALING))):
        raise AssertionError("tools.time_minimizer times another scheme")
    got = tm.measure(pk, ln, dev)
    if not all(got["equal"].values()):
        raise AssertionError(f"K5 differs from its twin: {got['equal']}")
    row = {"name": "minimizer_kmers", "route": "cuda",
           "source": "taxor_tpu_torch/csrc/minimizer.cu",
           "replaces": "taxor_tpu/hash/device_syncmer.py:636 (XLA, no "
                       "Pallas kernel)", "library_ms": None,
           "shape": [R, L], "window": MM_WINDOW,
           "max_abs_err": got["max_abs_err"]}
    n_emit = got["emissions"]["w7"]  # the scaled case's, before the keep
    for key, (name, window, scaling) in zip(("", "plain_kmer_", "scaled_"),
                                            tm.CASES):
        # packed + lengths in; hi, lo, valid, n_emit, n_unique out; the
        # keep's operations an emission
        b = bound(pk.numel() + 4 * R + 9 * R * L + 8 * R,
                  float(R * L) * k5_ops(MM_K, window)
                  + (n_emit * KEEP_OPS if scaling > 1 else 0), PEAK_SCALAR)
        log(f"time minimizer_kmers (K5) k={MM_K} window={window} scaling "
            f"{scaling} at R={R}, L={L}: kernel {got[f'{name}_ms']:.4f} ms "
            f"a call, {got[f'{name}_device_ms']:.4f} on the device alone; "
            f"plain {got[f'{name}_plain_ms']:.3f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); "
            f"{got['emissions'][name]} valid slots")
        row[f"{key}ms"] = got[f"{name}_ms"]
        row[f"{key}device_ms"] = got[f"{name}_device_ms"]
        row[f"{key}plain_ms"] = got[f"{name}_plain_ms"]
        if key:
            row[f"{key}bound_ms"] = b["bound_ms"]
        else:
            row.update(b)
    row["scaling_keep_ms"] = time_keep(
        torch, extract, pk, ln, scaling_threshold_u64(MM_SCALING))
    return row


def time_keep(torch, extract, packed, lengths, thresh: int) -> float:
    """Phase 13d: the FracMinHash keep as tensor ops
    (``extract.scaling_keep``, what followed K5 before K5 took the keep)
    on K5's output of the path's scheme, ms a call; its mask must equal
    K5's own keep and the keep on the CPU."""
    hi, lo, emit, _, _ = extract.minimizer_kmers(packed, lengths, MM_K,
                                                 MM_WINDOW)
    keep = extract.scaling_keep(hi, lo, thresh)
    if not torch.equal(keep.cpu(), extract.scaling_keep(hi.cpu(), lo.cpu(),
                                                        thresh)):
        raise AssertionError("the FracMinHash keep on the card differs "
                             "from the keep on the CPU")
    fused = extract.minimizer_kmers(packed, lengths, MM_K, MM_WINDOW,
                                    thresh)[2]
    if not torch.equal(fused, keep & emit):
        raise AssertionError("K5's FracMinHash keep differs from the keep "
                             "as tensor ops")
    ms1 = cuda_ms(lambda: extract.scaling_keep(hi, lo, thresh), 20)
    ms2 = cuda_ms(lambda: extract.scaling_keep(hi, lo, thresh), 20)
    log(f"time FracMinHash keep as tensor ops (scaling {MM_SCALING}) on "
        f"K5's [{hi.shape[0]}, {hi.shape[1]}] values: {ms1:.4f}/{ms2:.4f} "
        f"ms a call over all {hi.numel()} slots; {int(fused.sum())} of "
        f"{int(emit.sum())} emitted values kept; equal to K5's keep and to "
        f"the CPU's")
    return min(ms1, ms2)


def time_k2_kmer(torch, state) -> dict:
    """Phase 13d: K2 at phase 13b's own shape: the L=8192 bucket of its
    reads through K5 (plain k-mers: H = L hash slots, hundreds of hits a
    bin on a read's source genome), probed as the path probes them on
    its flat table, too tall for a slab (the rows route); bit-exact to
    the twin on every read of the batch, then timed against it."""
    from taxor_tpu_torch.device import e2e, probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.hash import device_syncmer as dsync

    dev = torch.device("cuda")
    dh = DeviceHIXF.from_hixf(state["index"].hixf, dev)
    L = 8192
    packed, lengths = (torch.from_numpy(x).to(dev) for x in dsync.pack_reads(
        bucket_reads(state["recs"], L), L))
    hi, lo, valid, _, _ = e2e._hashes(packed, lengths, "minimizer", MM_K, 0,
                                      0, MM_K, L, 0)
    R, H = hi.shape
    S_, Bp = dh.table.shape
    fn = lambda: probe.probe_counts(hi, lo, valid, dh.table,  # noqa: E731
                                    dh.seed, dh.block_length)
    plain = lambda: probe.probe_counts_plain(  # noqa: E731
        hi, lo, valid, dh.table, dh.seed, dh.block_length)
    before = probe.k2_counts.VARIANTS.get("rows", 0)
    got = fn()
    if probe.k2_counts.VARIANTS.get("rows", 0) != before + 1:
        raise AssertionError(f"K2 at phase 13b's table {(S_, Bp)} did not "
                             f"take the rows route")
    assert_equal(torch, f"K2 (rows) at phase 13b's shape R={R}, H={H}",
                 ("counts",), (got,), (plain(),))
    top = int(got.max())
    if top <= 256:
        raise AssertionError(f"K2 at phase 13b's shape: max count {top}, "
                             f"no count past 256")
    ms, plain_ms, err, each = time_pair(torch, fn, plain, 10)
    n_valid = int(valid.sum())
    b = bound(9 * R * H + S_ * Bp + 4 * R * Bp, float(n_valid) * Bp,
              PEAK_INT8)
    log(f"time probe_count_rows (K2 rows) at phase 13b's shape R={R}, "
        f"L=H={H}, table {(S_, Bp)}: bit-exact vs twin on every read "
        f"(max count {top}, {n_valid} valid hashes); kernel "
        f"{each[0]:.4f}/{each[1]:.4f} ms, plain {each[2]:.3f}/{each[3]:.3f} "
        f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"R": R, "H": H, "table": [S_, Bp], "ms": ms,
            "plain_ms": plain_ms, "max_abs_err": err, "max_count": top,
            "valid_hashes": n_valid, **b}


def time_descend_all(torch, state) -> list[dict]:
    """Phase 13d: every group of one descend-all batch of the minimiser
    hierarchy at L=8192 (R=512): all (subgroup, read) pairs active, the
    run-sum launch of each group a call (cuda_ms) and on the device alone
    (device_ms), bit-exact to the twin on the batch's first 16 reads."""
    from taxor_tpu_torch.device import e2e, probe
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF, _scale_thresh
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools.time_sort import device_ms

    dev = torch.device("cuda")
    index = state["index"]
    dh = DeviceHIXF.from_hixf(index.hixf, dev)
    L = 8192
    packed, lengths = dsync.pack_reads(bucket_reads(state["recs"], L), L)
    hi, lo, valid, _, _ = e2e._hashes(
        torch.from_numpy(packed).to(dev), torch.from_numpy(lengths).to(dev),
        "minimizer", MM_K, 0, 0, MM_WINDOW, L, _scale_thresh(index.scheme))
    R = hi.shape[0]
    rows = []
    for gi, g in enumerate(dh.groups):
        tables = g["tables"]
        act = torch.ones((tables.shape[0], R), dtype=torch.bool, device=dev)
        runs = (g["run_off"], g["run_s"], g["run_e"])
        sk = (g["seed"], g["bl"])
        fused = lambda: probe.probe_run_sums_grouped(  # noqa: E731
            hi, lo, valid, tables, act, *runs, *sk)
        got = fused()
        want = probe.probe_run_sums_grouped_plain(
            hi[:16], lo[:16], valid[:16], tables, act[:, :16], *runs, *sk)
        assert_equal(torch, f"descend-all group {gi}", ("sums",),
                     (got[:, :16],), (want,))
        first = cuda_ms(fused, 1)
        reps = max(1, min(20, int(40.0 / max(first, 1e-3))))
        a1, a2 = cuda_ms(fused, reps), cuda_ms(fused, reps)
        d1, d2 = device_ms(fused, reps, 1), device_ms(fused, reps, 1)
        n_runs = int(g["run_s"].shape[0])
        Bp = tables.shape[2]
        row = {"L": L, "R": R, "shape": list(tables.shape),
               "active_pairs": int(act.sum()), "pairs": act.numel(),
               "n_runs": n_runs,
               "mode": (probe.narrow_mode(*tables.shape[1:], dev)
                        if Bp <= probe.NARROW_MAX_BINS else "K2"),
               "ms": min(a1, a2), "device_ms": min(d1, d2),
               **narrow_bound(hi, valid, tables, act, n_runs)}
        rows.append(row)
        log(f"time descend-all group {gi} at L={L}, R={R}: tables "
            f"{tuple(tables.shape)}, {row['active_pairs']}/{row['pairs']} "
            f"pairs active, {n_runs} runs, mode {row['mode']}: run sums "
            f"{a1:.4f}/{a2:.4f} ms a call, {d1:.4f}/{d2:.4f} on the device "
            f"alone; bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    log(f"time descend-all batch at L={L}, R={R}: "
        f"{sum(r['device_ms'] for r in rows):.4f} ms on the device, "
        f"{sum(r['ms'] for r in rows):.4f} a call, bound "
        f"{sum(r['bound_ms'] for r in rows):.4f}; {int(valid.sum())} valid "
        f"hashes")
    return rows


# -------------------------------------------------- diagnostic kernels --
DIAG = {  # record name -> (wrapper name in device/diag.py, source, TPU kernel)
    "probe_bounds": ("probe_bounds", "taxor_tpu_torch/csrc/diag/probe_bounds.cu",
                     "bench_probe_bounds.py:33"),
    "probe_experiments": ("probe_experiment",
                          "taxor_tpu_torch/csrc/diag/probe_experiments.cu",
                          "bench_probe_r4.py:61"),
    "extract_stages": ("extract_stage",
                       "taxor_tpu_torch/csrc/diag/extract_stages.cu",
                       "tools/debug_extract.py:27"),
    "window_shift": ("window_shift",
                     "taxor_tpu_torch/csrc/diag/extract_stages.cu",
                     "tools/debug_min.py:22"),
}


def diag_counts(diag, zero: bool = False) -> dict:
    """{record name: launches} of the diagnostic wrappers (set to 0, and
    their ROUTES emptied)."""
    out = {}
    for name, (fn, _, _) in DIAG.items():
        wrapper = getattr(diag, fn)
        out[name] = wrapper.LAUNCHES
        if zero:
            wrapper.LAUNCHES = 0
            getattr(wrapper, "ROUTES", {}).clear()
    return out


def diag_routes(diag) -> dict:
    """{record name: {route: launches}} of the wrappers with routes."""
    return {name: dict(getattr(diag, fn).ROUTES)
            for name, (fn, _, _) in DIAG.items()
            if hasattr(getattr(diag, fn), "ROUTES")}


def check_probe_diags(torch, diag, label: str, table, bl: int, rand16, w16,
                      w10, n_hash, runs, modes=None) -> int:
    """probe_bounds (each of ``modes``, all by default) and
    probe_experiment (``runs``) on one table against their twins,
    bit-exact, through the route the shape picks and, where that is the
    slab route, through the rows route too; each launch's route is
    asserted from ROUTES, and the counts must agree in every layout.
    Returns the largest count."""
    S1, B = table.shape
    b = diag.slab_bins(S1, B, diag.smem_per_block(table.device))
    routes = [(False, "slab" if b else "rows")] + (
        [(True, "rows")] if b else [])
    top, first = 0, None
    for mode in modes or diag.PROBE_BOUNDS_MODES:
        want = diag.probe_bounds_plain(table, rand16, n_hash, mode)
        for rows, took in routes:
            before = diag.probe_bounds.ROUTES.get(took, 0)
            got = diag.probe_bounds(table, rand16, n_hash, mode, _rows=rows)
            assert diag.probe_bounds.ROUTES[took] == before + 1, took
            assert_equal(torch, f"probe_bounds {mode} ({label}, {took})",
                         ("counts",), (got,), (want,))
    for kw in runs:
        w = w10 if kw.get("layout") == "p10" else w16
        want = diag.probe_experiment_plain(table, w, n_hash, block_length=bl,
                                           **kw)
        for rows, took in routes if "flood_k" not in kw else [(False,
                                                               "flood")]:
            before = diag.probe_experiment.ROUTES.get(took, 0)
            got = diag.probe_experiment(table, w, n_hash, block_length=bl,
                                        _rows=rows, **kw)
            assert diag.probe_experiment.ROUTES[took] == before + 1, took
            assert_equal(torch, f"probe_experiment {kw} ({label}, {took})",
                         ("counts", "extra"), got, want)
        if "flood_k" not in kw:  # the same counts in every layout
            first = want[0] if first is None else first
            top = max(top, int(want[0].max()))
            assert_equal(torch, f"twin vs twin: probe_experiment_plain {kw} "
                         f"== its first run", ("counts",), (want[0],),
                         (first,))
    log(f"probe_bounds ({len(modes or diag.PROBE_BOUNDS_MODES)} modes) and "
        f"probe_experiment ({len(runs)} runs) on the {label} [{S1}, {B}] "
        f"(bl {bl}), R={n_hash.shape[0]}, n_hash 0..{int(n_hash.max())}: "
        f"routes {[t for _, t in routes]} (slab of {b} bins) bit-exact vs "
        f"twins, every layout alike, max count {top}")
    return top


def check_diag(torch, flat_table, flat_bl: int, rng) -> None:
    """Phase 11: every diagnostic kernel against its twin, bit-exact."""
    from taxor_tpu_torch.device import cuda_build, diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words

    dev = torch.device("cuda")
    R, H = 256, 512
    t0 = time.perf_counter()
    rand_tool = torch.from_numpy(pb.tool_table(rng)).to(dev)
    rand_16 = torch.from_numpy(pb.tool_table(rng, 10000, 64)).to(dev)
    rand_tall = torch.from_numpy(pb.tool_table(rng, 20000, 64)).to(dev)
    # the tools' geometry and the flat cell's table (slabs of 64 bins), a
    # ragged last slab of 36 bins (4-byte copies), slabs of 16 bins, and a
    # table past the shared memory (the rows route, picked by the shape)
    for label, table, bl in (("tool geometry", rand_tool, pe.BL_TOOL),
                             ("flat cell", flat_table, flat_bl),
                             ("ragged slab", rand_tool[:, :100].contiguous(),
                              pe.BL_TOOL),
                             ("16-bin slabs", rand_16, 3333),
                             ("tall table", rand_tall, 6666)):
        S1, B = table.shape
        n_np = rng.integers(0, H + 1, R).astype(np.int32)
        n_np[:8] = H  # full reads, one with no hash, one past its row
        n_np[8] = 0
        n_np[9] = H + 100
        n_hash = torch.from_numpy(n_np).to(dev)
        rand16 = torch.from_numpy(pb.make_inputs(rng, R, H, S1)).to(dev)
        w16, w10 = (torch.from_numpy(x).to(dev)
                    for x in pe.make_inputs(rng, R, H, S1, bl))
        check_probe_diags(torch, diag, label, table, bl, rand16, w16, w10,
                          n_hash, pe.CHECK_RUNS)
    # rows of words that 16-byte loads cannot take: H = 516 (129
    # fingerprint words), p16 rows of 2H + 2 words 4 bytes past alignment
    Hu = 516
    w16, w10 = pe.make_inputs(rng, R, Hu, 2419, pe.BL_TOOL)
    buf = torch.zeros(R * (2 * Hu + 2) + 1, dtype=torch.int32, device=dev)
    w16o = buf[1:].view(R, -1)
    w16o[:, :2 * Hu] = torch.from_numpy(w16).to(dev)
    n_hash = torch.from_numpy(rng.integers(0, Hu + 1, R).astype(
        np.int32)).to(dev)
    check_probe_diags(torch, diag, "unaligned words", rand_tool, pe.BL_TOOL,
                      w16o, w16o, torch.from_numpy(w10).to(dev), n_hash,
                      pe.CHECK_RUNS, modes=("p16",))
    # counts above 255: every hash hits every bin, up to 512 a read (a
    # read-lane writes its counts after 252 hashes, then adds to them
    # twice); 2,048 hashes on slabs of 128 bins (4 hash-lanes of 1,020
    # hashes a flush round)
    for (S1, B, bl, Hz), n in (((2419, 512, pe.BL_TOOL, 512),
                                (512, 300, 256, 255, 0)),
                               ((1500, 256, 499, 2048),
                                (2048, 1021, 1020, 7))):
        table, w16, w10 = (torch.from_numpy(x).to(dev) for x in
                           pe.zero_hit_inputs(rng, S1, B, bl, len(n), Hz))
        n_hash = torch.tensor(n, dtype=torch.int32, device=dev)
        top = check_probe_diags(torch, diag, f"zero-hit table, n {n}", table,
                                bl, w16, w16, w10, n_hash, pe.CHECK_RUNS[:7],
                                modes=("p16", "load1"))
        if top != max(n):
            raise AssertionError(f"zero-hit counts reach {top}, not {max(n)}")
    lib = cuda_build.diag_lib()
    for L in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        seqs = k1_reads(rng, L)
        packed, lengths = dsync.pack_reads(seqs, L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        for i, stage in enumerate(diag.STAGES):  # the wrapper's mirror
            if lib.extract_stage_smem(L, i) != diag.stage_smem(L, stage):
                raise AssertionError(f"stage_smem({L}, {stage}) differs "
                                     f"from the kernel's")
        emitted = []
        for k, s, t in STAGE_SCHEMES:
            want = diag.extract_stages_plain(pk, ln, k, s, t)
            for stage in diag.STAGES:
                assert_equal(torch, f"extract_stage {stage} (k={k}, s={s}, "
                             f"t={t}) L={L}", (stage,),
                             (diag.extract_stage(pk, ln, k, s, t, stage),),
                             (want[stage],))
            emitted.append(int(want["emit"].sum()))
        x = torch.from_numpy(stream_words(packed)).to(dev)
        for phases in (range(16), [15, 3, 11, 0, 3]):
            assert_equal(torch, f"window_shift {list(phases)} L={L}",
                         ("words",), (diag.window_shift(x, phases),),
                         (diag.window_shift_plain(x, phases),))
        xo = x[:, :x.shape[1] - 3].contiguous()  # Wd no multiple of 4
        assert_equal(torch, f"window_shift Wd={xo.shape[1]}", ("words",),
                     (diag.window_shift(xo),),
                     (diag.window_shift_plain(xo, range(16)),))
        log(f"extract_stage (10 stages, schemes {STAGE_SCHEMES}) and "
            f"window_shift (16 phases, a reordered list, Wd = L/16 and "
            f"L/16 - 3) L={L}: bit-exact vs twins on {len(seqs)} reads "
            f"({emitted} emissions)")
    log(f"phase 11: diagnostic kernels checked in "
        f"{time.perf_counter() - t0:.1f} s")


def cli_tools(torch, work: str) -> dict:
    """``cli prewarm`` and ``cli search --profile-trace`` on a flat index
    of build_problem(64 genomes of 20 kb, 2,048 reads of 2 kb); returns
    their seconds."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.tools import synth

    _, tsv, gdir, reads = synth.build_problem(
        n_species=64, genome_len=20000, n_reads=2048, read_len=2000,
        root=work)
    idx = os.path.join(work, "tools.taxor.npz")
    cwd = os.getcwd()
    os.chdir(work)  # the build writes its layout file (binning.out) here
    try:
        rc = cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                       gdir, "--output-filename", idx, "--kmer-size",
                       str(K), "--syncmer-size", str(S), "--use-syncmer",
                       "--layout", "flat"])
    finally:
        os.chdir(cwd)
    secs = {}
    t0 = time.perf_counter()
    rc |= cli.main(["prewarm", "--index-file", idx, "--lengths",
                    "1024,2048,4096", "--device", "cuda"])
    secs["prewarm"] = time.perf_counter() - t0
    trace = os.path.join(work, "trace")
    t0 = time.perf_counter()
    rc |= cli.main(["search", "--index-file", idx, "--query-file", reads,
                    "--output-file", os.path.join(work, "traced.tsv"),
                    "--engine", "device", "--device", "cuda",
                    "--profile-trace", trace])
    secs["search --profile-trace"] = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError("cli build, prewarm or traced search failed")
    with open(os.path.join(trace, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    on_card = [e for e in events if e.get("cat") == "kernel"]
    names = sorted({e["name"] for e in on_card})
    log(f"cli prewarm {secs['prewarm']:.1f} s; search --profile-trace "
        f"{secs['search --profile-trace']:.1f} s, trace of {len(events)} "
        f"events, {len(on_card)} kernels on the card "
        f"({sum(e.get('dur', 0) for e in on_card) / 1e3:.3f} ms), e.g. "
        f"{[n[:60] for n in names[:4]]}")
    return secs


def tool_path(torch, modules, work: str) -> tuple[dict, dict]:
    """Phase 12: the tooling path through its entry points, the launch
    counts of every kernel set to 0 just before and read just after;
    returns the diagnostic launches, and those by route."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.tools import (bench, debug_extract, debug_min,
                                       probe_bounds, probe_experiments,
                                       profile_phases)

    reset_counts(*modules)
    diag_counts(diag, zero=True)
    secs = {}
    t0 = time.perf_counter()
    result, rc = bench.run(["--configs", bench.PRIMARY])
    secs["bench"] = time.perf_counter() - t0
    cfg = result["detail"]["configs"][0]
    log(f"tools.bench ({secs['bench']:.1f} s): rc {rc}; {bench.PRIMARY}: "
        f"device compute {cfg.get('device_compute_reads_per_s')} reads/s "
        f"({cfg.get('ms_per_pass')} ms a pass), full pipeline "
        f"{result['full_pipeline_reads_per_s']} reads/s, native baseline "
        f"{cfg.get('baseline_1thread_reads_per_s')} reads/s a thread, "
        f"fallback {cfg.get('host_fallback_fraction')}; parity "
        f"{result['parity']}")
    if rc != 0 or not result["parity_ok"] or result["skipped"] \
            or result["parity"] != {f: True for f in bench.FAMILIES}:
        raise AssertionError(f"tools.bench failed: rc {rc}, {result}")
    routes = result["parity_routes"]
    log(f"tools.bench parity: device routes by family {routes}")
    if any(routes[f]["fused"] <= 0 for f in bench.FAMILIES):
        raise AssertionError(f"a parity family took no fused step: {routes}")
    t0 = time.perf_counter()
    bounds = probe_bounds.run("cuda")
    secs["probe_bounds"] = time.perf_counter() - t0
    exps = {}
    t0 = time.perf_counter()
    for name in probe_experiments.LISTS:
        exps[name] = probe_experiments.run(name, "cuda")
    secs["probe_experiments"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases = profile_phases.profile("cuda")
    secs["profile_phases"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if debug_extract.main(["--stage", "all", "--device", "cuda"]) != 0 \
            or debug_min.main(["--device", "cuda"]) != 0:
        raise AssertionError("debug_extract or debug_min found a difference")
    secs["debug"] = time.perf_counter() - t0
    secs.update(cli_tools(torch, work))
    counts = diag_counts(diag)
    routes = diag_routes(diag)
    launches = read_counts(*modules[:3])
    log(f"tool path: probe_bounds ns/hash "
        f"{ {k: round(v['ns_per_hash'], 4) for k, v in bounds.items()} }")
    for name, rows in exps.items():
        log(f"tool path: probe_experiments {name}: "
            f"{[(r['mode'], r['U'], r['nops'], round(r['ms'], 4)) for r in rows]}")
    log(f"tool path: profile_phases ms {json.dumps(phases)}")
    log(f"tool path: seconds {({k: round(v, 1) for k, v in secs.items()})}; "
        f"diagnostic launches {counts}, by route {routes}; search kernel "
        f"launches {launches}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the tooling path skipped a diagnostic kernel: "
                             f"{counts}")
    if set(routes["probe_bounds"]) != {"slab"} \
            or set(routes["probe_experiments"]) != {"slab", "flood"}:
        raise AssertionError(f"the probe tools left their slab route: "
                             f"{routes}")
    return counts, routes


def time_stages(torch, seqs, pk, ln, words) -> tuple[dict, float]:
    """extract_stage in stages sf, chi, erm, emit and pre on the batch
    (packed pk, lengths ln of seqs), pre on as many reads tied in every
    window (``pre_tied``) and on the batch's longest read alone
    (``pre_one``: one read's serial chain of tracker steps, the floor of
    emit and pre), and window_shift on the stream words, through
    ``tools.time_stages.measure``: each held to its twin, then timed a
    call and on the device alone.  Returns the stages' times beside
    their bytes bounds, and window_shift's device time."""
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import time_stages as ts
    from taxor_tpu_torch.tools.time_extract import all_tied_reads

    R, L = pk.shape[0], pk.shape[1] * 4
    tied = [torch.from_numpy(x).to(pk.device) for x in dsync.pack_reads(
        all_tied_reads(np.random.default_rng(SEED + 13), L, R), L)]
    one = max(range(R), key=lambda r: len(seqs[r]))
    got = ts.measure({"": (pk, ln), "_tied": tied,
                      "_one": (pk[one:one + 1], ln[one:one + 1])}, words,
                     pk.device)
    if not all(got["equal"].values()):
        raise AssertionError(f"extract_stage or window_shift differs from "
                             f"its twin: {got['equal']}")
    out = {}
    for name in (*ts.STAGES, "pre_tied", "pre_one"):
        rows = 1 if name == "pre_one" else R
        out[name] = {"ms": got[f"{name}_ms"],
                     "device_ms": got[f"{name}_device_ms"], **bound(
                         (L // 4 + 4 + (1 if name == "emit" else 8) * L)
                         * rows, 0.0, PEAK_SCALAR)}
        log(f"time extract_stage {name} ({rows} reads, L={L}): a call "
            f"{out[name]['ms']:.4f} ms, device {out[name]['device_ms']:.4f}"
            f" ms, bound {out[name]['bound_ms']:.4f} ms")
    out["pre_one"]["length"] = int(ln[one])
    return out, got["window_shift_device_ms"]


def time_diag(torch, state) -> list[dict]:
    """The four diagnostic kernels against their twins: the probe
    variants at the JAX tools' geometry (R=8192, H=512, 176 hashes a
    read, 2,419 slots x 512 bins), the stage dump (stage ``pre``, the
    tracker; then five stages and two more batches, ``time_stages``) and
    the window shift (also on the device alone) at the flat path's
    L=8192 bucket.  The two probe diagnostics, which take their slab
    route there, are also timed on the device alone (device_ms) and
    through their rows route at the same shape, a call and on the device
    alone, beside the floor of their shared-memory row reads."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words
    from taxor_tpu_torch.tools.time_sort import device_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    R, H, n = pb.R_TOOL, pb.H_TOOL, pb.n_probed(pb.NVALID)
    table = torch.from_numpy(pb.tool_table(rng)).to(dev)
    S1, B = table.shape
    w16 = torch.from_numpy(pb.make_inputs(rng, R, H, S1)).to(dev)
    w10 = torch.from_numpy(pe.make_inputs(rng, R, H, S1, pe.BL_TOOL)[1]).to(
        dev)
    n_hash = torch.full((R,), n, dtype=torch.int32, device=dev)
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    words = torch.from_numpy(stream_words(packed)).to(dev)
    Rs, Wd = words.shape
    t = (K - S + 1) // 2
    probe_out = 4 * R * B + S1 * B + 4 * R  # counts out, table, n_hash
    cases = (
        ("probe_bounds", f"p16 at R={R}, n={n}, table [{S1}, {B}]",
         lambda: diag.probe_bounds(table, w16, n_hash, "p16"),
         lambda: diag.probe_bounds_plain(table, w16, n_hash, "p16"), 20,
         # the position words of the probed hashes; one fingerprint-byte
         # compare per hash and bin
         bound(8 * R * n + probe_out, float(R * n * B), PEAK_INT8)),
        ("probe_experiments", f"p10, one read a thread, at R={R}, n={n}",
         lambda: diag.probe_experiment(table, w10, n_hash, "p10",
                                       block_length=pe.BL_TOOL),
         lambda: diag.probe_experiment_plain(table, w10, n_hash, "p10",
                                             block_length=pe.BL_TOOL), 20,
         bound(5 * R * n + probe_out + 4 * R, float(R * n * B), PEAK_INT8)),
        ("extract_stages", f"stage pre at R={Rs}, L={L}",
         lambda: diag.extract_stage(pk, ln, K, S, t, "pre"),
         lambda: diag.extract_stage_plain(pk, ln, K, S, t, "pre"), 5,
         # packed + lengths in, 8 bytes a position out; a tracker step
         # per base
         bound(pk.numel() + 4 * Rs + 8 * Rs * L, float(ln.sum()),
               PEAK_SCALAR)),
        ("window_shift", f"16 phases of [{Rs}, {Wd}] stream words",
         lambda: diag.window_shift(words),
         lambda: diag.window_shift_plain(words, range(16)), 50,
         bound(4 * Rs * Wd * 17 + 64, 16.0 * Rs * Wd, PEAK_SCALAR)),
    )
    # the floor no slab design gets under: 3 rows x B bytes a probed hash
    # from shared memory, at 128 B a clock an SM, 132 SMs, 1.98 GHz
    smem_floor_ms = 3 * B * R * n / SMEM_BPS * 1e3
    slab = diag.slab_bins(S1, B, diag.smem_per_block(dev))
    rows = []
    for name, shape, fn, plain, reps, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        log(f"time {name} ({shape}): kernel {each[0]:.4f}/{each[1]:.4f} ms, "
            f"plain {each[2]:.3f}/{each[3]:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": DIAG[name][1],
                     "replaces": DIAG[name][2], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": None})
        if name == "extract_stages":
            rows[-1]["stages"], shift_dev = time_stages(torch, seqs, pk, ln,
                                                        words)
        if name == "window_shift":
            rows[-1]["device_ms"] = shift_dev
            log(f"time window_shift: device {shift_dev:.4f} ms")
        if name not in ("probe_bounds", "probe_experiments"):
            continue
        # on the device alone, and the rows route at the same shape, each
        # held to the same twin: slab, rows, rows, slab
        rows_fn = {"probe_bounds": lambda: diag.probe_bounds(
            table, w16, n_hash, "p16", _rows=True),
            "probe_experiments": lambda: diag.probe_experiment(
                table, w10, n_hash, "p10", block_length=pe.BL_TOOL,
                _rows=True)}[name]
        dev_ms = [device_ms(fn, reps, rounds=1)]
        rows_ms, _, _, rows_each = time_pair(torch, rows_fn, plain, reps)
        rows_dev = [device_ms(rows_fn, reps, rounds=1),
                    device_ms(rows_fn, reps, rounds=1)]
        dev_ms.append(device_ms(fn, reps, rounds=1))
        rows[-1].update(
            slab_bins=slab, device_ms=min(dev_ms), rows_ms=rows_ms,
            rows_device_ms=min(rows_dev),
            times={"slab_call": each[:2], "slab_device": dev_ms,
                   "rows_call": rows_each[:2], "rows_device": rows_dev})
        log(f"time {name}: slab route ({slab} bins) a call "
            f"{each[0]:.4f}/{each[1]:.4f} ms, device {dev_ms[0]:.4f}/"
            f"{dev_ms[1]:.4f} ms; rows route a call {rows_each[0]:.4f}/"
            f"{rows_each[1]:.4f} ms, device {rows_dev[0]:.4f}/"
            f"{rows_dev[1]:.4f} ms; shared-memory floor "
            f"{smem_floor_ms:.4f} ms")
    return rows


# ------------------------------------------------------------ phase 14 --
RANK_TIMEOUT = 420  # seconds a sharded search's ranks may take


def rank_main(counts_file: str, argv: list[str]) -> int:
    """One rank of a phase 14 search: ``cli.main(argv)`` (the argv of
    ``python -m taxor_tpu_torch.cli search ...``) with every launch count
    set to 0 just before, then this rank's launches, routes, wall, peak
    device memory and collective seconds written to counts_file."""
    import torch

    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device import extract, probe, sharding, sort
    from taxor_tpu_torch.search import pipeline

    reset_counts(extract, probe, sort, pipeline)
    sharding.COLLECTIVES.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    rec = {"rc": rc, "wall_s": wall,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
           "launches": read_counts(extract, probe, sort),
           "routes": dict(pipeline.ROUTES.counts),
           "collectives": sharding.COLLECTIVES.summary()}
    with open(counts_file, "w") as fh:
        json.dump(rec, fh)
    return rc


def run_ranks(cmds, logs, timeout: float) -> list[int]:
    """Start every command at once, each logging to its file; wait for
    all, and stop the others as soon as one fails.  Return codes."""
    procs = []
    try:
        for cmd, path in zip(cmds, logs):
            with open(path, "w") as fh:
                procs.append(subprocess.Popen(cmd, stdout=fh,
                                              stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]


def tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as fh:
        return fh.read()[-n:]


def sharded_search(work: str, label: str, state: dict, ranks: int,
                   mesh: list[str], need, card: str) -> dict:
    """``cli search --engine sharded --distributed`` of ``state``'s index
    and reads in ``ranks`` processes on the card (gloo where they share
    it, NCCL for one rank: distributed.collective_backend), each through
    ``rank_main``; every rank must exit 0, the kernels ``need`` must have
    launched in the ranks, and rank 0's TSV must equal the phase's
    single-device ``--engine device`` TSV byte for byte.  Logs the
    backend, the mesh and each rank's launches, wall, peak device memory
    and collective seconds a batch (CUDA events around each all_gather
    and all_reduce)."""
    from taxor_tpu_torch.tools.dryrun_multichip import free_port

    port = free_port()
    out = os.path.join(work, f"{label}_sharded.tsv")
    threads = str(max(1, (os.cpu_count() or 1) // ranks))
    cmds, logs, files = [], [], []
    for r in range(ranks):
        files.append(os.path.join(work, f"{label}_rank{r}.json"))
        logs.append(os.path.join(work, f"{label}_rank{r}.log"))
        cmds.append([sys.executable, os.path.abspath(__file__), "--rank",
                     files[-1], "search", "--index-file", state["idx"],
                     "--query-file", state["reads"], "--output-file", out,
                     "--engine", "sharded", "--distributed",
                     "--coordinator-address", f"127.0.0.1:{port}",
                     "--num-processes", str(ranks), "--process-id", str(r),
                     *mesh, "--device", "cuda", "--threads", threads,
                     "--write-time"])
    t0 = time.perf_counter()
    rcs = run_ranks(cmds, logs, RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    if any(rcs):
        raise RuntimeError(f"[{label}] sharded search: rank return codes "
                           f"{rcs}\n" + "\n".join(
                               f"--- rank {r}\n{tail(p)}"
                               for r, p in enumerate(logs)))
    recs = []
    for path in files:
        with open(path) as fh:
            recs.append(json.load(fh))
    total = {k: sum(r["launches"][k] for r in recs)
             for k, v in recs[0]["launches"].items() if isinstance(v, int)}
    if any(total[k] <= 0 for k in need):
        raise AssertionError(f"[{label}] the ranks skipped one of {need}: "
                             f"{total}")
    with open(out, "rb") as fa, open(state["device_tsv"], "rb") as fb:
        got, want = fa.read(), fb.read()
    if got != want:
        a, b = got.splitlines(), want.splitlines()
        bad = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        raise AssertionError(f"[{label}] sharded TSV differs from the device "
                             f"TSV at row {bad} ({len(a)} vs {len(b)} rows)")
    backend = next(line for line in tail(logs[0], 10**6).splitlines()
                   if "collectives on" in line)
    log(f"[{label}] sharded search, {ranks} rank(s) {' '.join(mesh)}: "
        f"{len(want.splitlines()) - 1} rows == the device TSV byte for "
        f"byte; {wall:.2f} s wall for all ranks (start-up included); "
        f"{backend.strip()}; launches summed over the ranks {total}; {card}")
    for r, rec in enumerate(recs):
        c = rec["collectives"]
        dev_s = c["device_s"] or 0.0
        log(f"[{label}]   rank {r}: {c['mesh']}; wall {rec['wall_s']:.2f} s; "
            f"peak device memory {rec['peak_mib']:.1f} MiB; launches "
            f"{ {k: v for k, v in rec['launches'].items() if v} }; routes "
            f"{rec['routes']}; collectives {c['calls']} calls over "
            f"{c['batches']} batches: {dev_s:.4f} s on the card (CUDA "
            f"events), {c['host_s']:.4f} s host, "
            f"{dev_s / max(1, c['batches']) * 1e3:.3f} ms a batch; {card}")
    return {"launches": total, "ranks": recs, "wall": wall}


def flat_probe(state: dict, nb: int) -> str:
    """The probe kernel of a flat index's bins shard: K2 past 512 bins,
    else K2n (a quick-start flat index of fewer than 513 genomes)."""
    from taxor_tpu_torch.device.probe import LANE, NARROW_MAX_BINS, pad_bins

    bins = state["index"].hixf.ixfs[0].fingerprints.shape[1]
    return "K2" if pad_bins(bins, LANE * nb) // nb > NARROW_MAX_BINS \
        else "K2n"


def dryrun_on_card(card: str) -> None:
    """Phase 14e: tools.dryrun_multichip over 4 ranks on the card."""
    res = subprocess.run(
        [sys.executable, "-m", "taxor_tpu_torch.tools.dryrun_multichip",
         "--ranks", "4", "--device", "cuda"], capture_output=True, text=True,
        timeout=RANK_TIMEOUT, cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise RuntimeError(f"dryrun_multichip failed ({res.returncode}):\n"
                           + res.stdout[-2000:] + res.stderr[-3000:])
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if not (out.get("count_step") and out.get("fused_step")):
        raise AssertionError(f"dryrun_multichip: {out}")
    log(f"phase 14e: dryrun_multichip over 4 ranks: {out}; {card}")


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:  # one rank of a phase 14 search
        return rank_main(sys.argv[2], sys.argv[3:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genomes", type=int, default=4096,
                    help="reference genomes of 30 kb in the flat index")
    ap.add_argument("--reads", type=int, default=8192,
                    help="ONT-like reads of the flat path (plus 16 of 40 kb)")
    ap.add_argument("--hier-genomes", type=int, default=8192,
                    help="reference genomes of 30 kb in the hierarchical "
                         "index")
    ap.add_argument("--hier-reads", type=int, default=16384,
                    help="ONT-like reads of the hierarchical path (plus 16 "
                         "of 40 kb)")
    ap.add_argument("--kmer-genomes", type=int, default=1024,
                    help="reference genomes of 30 kb in phase 13b's flat "
                         "plain k-mer index")
    ap.add_argument("--kmer-reads", type=int, default=4096,
                    help="ONT-like reads of phase 13b (plus 16 of 40 kb)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from taxor_tpu_torch.device import cuda_build, extract, probe, sort
    from taxor_tpu_torch.hash import device_syncmer as dsync

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:  # every nvcc of both libraries at once
        for built in [ex.submit(cuda_build.lib),
                      ex.submit(cuda_build.diag_lib)]:
            built.result()
    log(f"build: search and diagnostic kernels compiled and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    with phase("phase 2 (K1, syncmer_track and K3 checks)"):
        check_k1(torch, dsync, extract, sort, rng)
    with phase("phase 3"):
        k2_rows_checks = check_k2(torch, probe, rng)
    with phase("phase 9 (K3 and K4 checks)"):
        check_sorts(torch, sort, rng)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "taxor_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    try:
        with phase("phase 4"):
            flat = main_path(torch, os.path.join(work, "flat"), rng,
                             args.genomes, args.reads, "flat")
        with phase("phases 5 and 10"):
            kernels = time_kernels(torch, flat)
            kernels += time_split(torch, flat)
        # ---- phase 14: the sharded engine on phase 4's flat cell
        t14 = time.perf_counter()
        with phase("phase 14a"):
            sharded = [sharded_search(
                os.path.join(work, "flat"), "flat 2x2", flat, 4,
                ["--mesh-reads", "2", "--mesh-bins", "2"],
                ("K1", flat_probe(flat, 2)), card)]
        with phase("phase 14d"):
            sharded.append(sharded_search(
                os.path.join(work, "flat"), "flat 1 rank", flat, 1, [],
                ("K1", flat_probe(flat, 1)), card))
        with phase("phase 14e"):
            dryrun_on_card(card)
        t14 = time.perf_counter() - t14
        shutil.rmtree(os.path.join(work, "flat"), ignore_errors=True)
        with phase("phase 6"):
            k2_rows_checks += check_grouped(torch, probe, rng)
            check_run_sums(torch, probe, rng)
        with phase("phase 7"):
            hier = main_path(torch, os.path.join(work, "hier"), rng,
                             args.hier_genomes, args.hier_reads, "auto")
            hier_report(torch, hier)
            check_wide_root(torch, os.path.join(work, "wide"))
        with phase("phase 8"):
            kernels += time_hier(torch, hier)

        # ---- phase 13: K5, minimisers and plain k-mers, descend-all
        t13 = time.perf_counter()
        with phase("phase 13c"):
            check_k5(torch, dsync, extract, rng)
        # 13a: phase 7's genomes and reads under the bench family's whole
        # scheme (scaling 3)
        mm_flags = ["--kmer-size", str(MM_K), "--window-size",
                    str(MM_WINDOW), "--scaling", str(MM_SCALING)]
        with phase("phase 13a"):
            mm = nonsyncmer_path(torch, os.path.join(work, "hier"),
                                 "minimizer", hier, mm_flags, "auto",
                                 ("K5", "K2n"))
        if mm["active_share"] != 1.0:
            raise AssertionError(f"[minimizer] the descend-all descent left "
                                 f"pairs inactive: {mm['active_share']}")
        with phase("phase 13d (K5, the keep, descend-all)"):
            kernels.append(time_k5(torch, mm))
            narrow = next(r for r in kernels
                          if r["name"] == "probe_count_narrow")
            narrow["descend_all_groups"] = time_descend_all(torch, mm)
        # ---- phase 14 on phase 7's and phase 13a's hierarchies
        t0 = time.perf_counter()
        with phase("phase 14b"):
            sharded.append(sharded_search(
                os.path.join(work, "hier"), "hier 2x2", hier, 4,
                ["--mesh-reads", "2", "--mesh-bins", "2"], ("K1", "K2n"),
                card))
        with phase("phase 14c"):
            sharded.append(sharded_search(
                os.path.join(work, "hier"), "minimizer 1x2", mm, 2,
                ["--mesh-bins", "2"], ("K5", "K2n"), card))
        t14 += time.perf_counter() - t0
        log(f"phase 14: {t14:.1f} s")
        shutil.rmtree(os.path.join(work, "hier"), ignore_errors=True)
        with phase("phase 13b"):
            kmer_in = kmer_data(rng, os.path.join(work, "kmer"),
                                args.kmer_genomes, args.kmer_reads)
            kmer = nonsyncmer_path(torch, os.path.join(work, "kmer"), "kmer",
                                   kmer_in, ["--kmer-size", str(MM_K),
                                             "--window-size", str(MM_K)],
                                   "flat", ("K5", "K2"))
        with phase("phase 13d (K2 at 13b's shape)"):
            rows = next(r for r in kernels if r["name"] == "probe_count_rows")
            rows["kmer_flat"] = time_k2_kmer(torch, kmer)
        # 13e: the same scheme on a flat layout of 13b's genomes
        with phase("phase 13e"):
            scaled = nonsyncmer_path(torch, os.path.join(work, "kmer"),
                                     "scaled", kmer_in, mm_flags, "flat",
                                     ("K5", "K2"))
        log(f"phase 13: {time.perf_counter() - t13:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    runs = [flat["launches"], flat["split"], hier["launches"], hier["split"],
            mm["launches"], kmer["launches"], scaled["launches"]]
    for row in kernels:  # launches on the main paths, both engines
        key = {"syncmer_extract": "K1", "probe_count": "K2 slab",
               "probe_count_rows": "K2 rows", "probe_count_narrow": "K2n",
               "syncmer_track": "track", "dedup": "K3",
               "sort_pairs": "K4", "minimizer_kmers": "K5"}[row["name"]]
        row["launches"] = sum(run[key] for run in runs)
        row["launches_in"] = "main paths"
        # phase 14: summed over the ranks of its four sharded searches
        row["sharded_launches"] = sum(run["launches"].get(key, 0)
                                      for run in sharded)
        if key == "K2n":
            row["modes"] = {m: sum(run[f"K2n {m}"] for run in runs)
                            for m in ("smem", "rows")}
            row["peak_mib"] = {"hierarchical": hier["peak_mib"],
                               "hierarchical split": hier["split_peak_mib"],
                               "minimizer descend-all": mm["peak_mib"]}
        if key == "K4":  # as in the JAX package, no search path sorts pairs
            row["launches_in"] = "not on a main path"
            row["check_launches"] = flat["k4_check"]  # sort.dedup_pairs
        if key == "K2 rows" and row["launches"] == 0:  # no table too tall
            row["launches_in"] = "not on a main path"
            row["check_launches"] = k2_rows_checks  # phases 3 and 6

    # ---- phases 11 and 12: the diagnostic kernels and the tooling path
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.device.hixf_search import DeviceHIXF
    from taxor_tpu_torch.search import pipeline

    dh = DeviceHIXF.from_hixf(flat["index"].hixf, "cuda")
    diag_counts(diag, zero=True)
    with phase("phase 11"):
        check_diag(torch, dh.table, dh.block_length,
                   np.random.default_rng(SEED + 11))
    checks = diag_counts(diag)
    check_routes = diag_routes(diag)
    del dh
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir=root)
    try:
        tools, tool_routes = tool_path(torch, (extract, probe, sort,
                                               pipeline), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 12: tooling path in {time.perf_counter() - t0:.1f} s")
    with phase("phase 12 (the diagnostic kernels timed)"):
        diag_rows = time_diag(torch, flat)
    for row in diag_rows:
        row.update(launches=tools[row["name"]], launches_in="tools",
                   tool_launches=tools[row["name"]],
                   check_launches=checks[row["name"]])
        if row["name"] in tool_routes:  # launches by route
            row.update(routes=tool_routes[row["name"]],
                       check_routes=check_routes[row["name"]])
        kernels.append(row)
    if any(r["launches"] <= 0 for r in kernels
           if r["launches_in"] != "not on a main path"):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{kernels}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
