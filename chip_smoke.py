#!/usr/bin/env python3
"""Smoke test of taxor_tpu_torch on one CUDA GPU (built for the H100).

    python3 chip_smoke.py                 # full size, ~4-8 min on an H100
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
     mask against their twin, bit-exact, at 16..512 bins (K2n) and 4,096
     bins (K2, through both variants), with fingerprint-0 slots, counts
     above 256 and a read inactive everywhere;
  7. the hierarchical main path: the same recipe on an index built with
     ``--layout auto --tmax 64`` (a 64-bin root); K1, the grouped probe
     and the per-IXF traversal of the reads over L_CAP must have
     launched, the TSV must equal ``--engine host`` on a subset, and 99%
     of the classified reads must name their source genome; then the
     split engine on the same reads, as in phase 4;
  8. K2n and K2 (the variant each shape picks) timed against their twin
     on the root group and on one stacked level at the hierarchical
     path's L=8192 bucket;
  9. K4 (pair sort) against its twin, bit-exact, at W = 100, 128, 8192
     and 32768 (global scratch) with duplicated keys and keys equal to
     the sentinel; K3 on a row that breaks min_gap (n_emit = 2**30); and,
     after phase 4, K3 against ``sort.dedup_pairs`` (K4) on the flat
     path's L=8192 reads.  No search path reaches K4 (in the JAX package
     only ``sort_impl="pallas"`` does): its record counts 0 main-path
     launches and, apart, the launches of that one check;
 10. syncmer_track, K3 and K4 timed against their twins, K4 against
     ``torch.sort`` of the combined key, and the split engine's
     extraction against K1, at the flat path's L=8192 bucket;
     syncmer_track also on phase 5's batch tied in every window;
 11. the tools' four diagnostic kernels (csrc/diag/) against their plain
     twins, bit-exact: probe_bounds in its five modes and
     probe_experiment in both position layouts, 1, 2 and 4 reads a
     thread, 4, 8 and 16 ALU rounds and the position-word flood (K = 2,
     4, 8), at R=256 on the TPU tools' geometry (2,419 slots x 512 bins)
     and on the flat cell's table; extract_stage in all ten stages at
     every length bucket 256..32768 on phase 2's kinds of reads; and
     window_shift for all 16 phases on the same reads' stream words;
 12. the tooling path, with every launch count set to 0 just before it:
     ``tools.bench`` on its primary config (viral_flat_256) with its
     parity gate (five scheme/layout families, device TSV == host TSV),
     ``tools.probe_bounds``, ``tools.probe_experiments`` (its three
     experiment lists) and ``tools.profile_phases`` at the JAX tools'
     sizes (R=8192, H=512, nvalid=173; build_problem's 8,192 reads), and
     ``tools.debug_extract --stage all`` and ``tools.debug_min``, and
     ``cli prewarm`` and ``cli search --profile-trace`` on a small flat
     index (the trace's kernels on the card are counted); then the four
     diagnostic kernels timed against their twins.  Their
     records count the tooling path's launches (``launches_in``:
     "tools"), with phase 11's apart as ``check_launches``.

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

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K, S = 22, 12  # the reference's published syncmer scheme
GENOME_LEN = 30000
LONG_READS = 16  # of 40 kb: over L_CAP, the host-hash route
TMAX = 64  # technical bins per IXF of the hierarchical index
CHECK_READS = 1024  # first reads held byte-equal to --engine host
SEED = 20261016
HBM_BPS = 3.35e12  # H100 SXM device memory rate
PEAK_SCALAR = 67e12  # fp32 outside the tensor cores: integer/compare work
PEAK_INT8 = 1979e12  # int8 (fingerprint bytes)


def log(msg: str) -> None:
    print(msg, flush=True)


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
        where = ("global scratch" if 64 + 8 * Wb > extract.SMEM_LIMIT
                 else "shared memory")
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
            if (int(got[:, 0].max()) <= 256
                    or int(got[:, R - 1].abs().sum()) != 0):
                raise AssertionError(f"grouped probe Bpad={Bp} G={G}: case "
                                     "did not exercise counts > 256 / "
                                     "inactive reads")
            name = ("K2n" if kernel is probe.k2n_counts else
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


# ------------------------------------------------------------- K3, K4 --
def check_sorts(torch, sort, rng) -> None:
    """K4 at four widths, and K3 on a row that breaks min_gap."""
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
        log(f"K4 [{R}, {W}]: bit-exact vs twin (duplicated and sentinel "
            f"keys, {'global scratch' if W > 16384 else 'shared memory'})")
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
              sort.dedup_fused, sort.sort_pairs):
        k.LAUNCHES = 0
    for k in (probe.k2_counts, probe.k2n_counts):
        k.LAUNCHES = 0
        k.ROUTES = {}
    probe.k2_counts.VARIANTS = {}
    pipeline.ROUTES.reset()


def read_counts(extract, probe, sort) -> dict:
    return {"K1": extract.syncmer_hashes.LAUNCHES,
            "K2": probe.k2_counts.LAUNCHES, "K2n": probe.k2n_counts.LAUNCHES,
            "K2 slab": probe.k2_counts.VARIANTS.get("slab", 0),
            "K2 rows": probe.k2_counts.VARIANTS.get("rows", 0),
            "track": extract.syncmer_track.LAUNCHES,
            "K3": sort.dedup_fused.LAUNCHES, "K4": sort.sort_pairs.LAUNCHES,
            "K2 routes": dict(probe.k2_counts.ROUTES),
            "K2n routes": dict(probe.k2n_counts.ROUTES)}


def main_path(torch, work: str, rng, n_genomes: int, n_reads: int,
              layout: str) -> dict:
    """Build an index of n_genomes with --layout ``layout``, search
    n_reads + LONG_READS through the device engine with the launch
    counts set to 0 just before, check the TSV against --engine host on
    a subset and the classifications against the source genomes."""
    from taxor_tpu_torch import cli
    from taxor_tpu_torch.device import e2e, extract, probe, sort
    from taxor_tpu_torch.search import pipeline

    threads = str(os.cpu_count() or 1)
    t0 = time.perf_counter()
    tsv, gdir, genomes = make_genomes(rng, work, n_genomes, GENOME_LEN)
    recs = make_reads(rng, genomes, n_reads, LONG_READS)
    reads = os.path.join(work, "reads.fasta")
    write_fasta(reads, recs)
    log(f"[{layout}] data: {n_genomes} genomes x {GENOME_LEN} b, {n_reads} "
        f"reads ({sum(len(s) for _, s in recs[:n_reads]) / 1e6:.1f} Mb) + "
        f"{LONG_READS} x 40 kb, made in {time.perf_counter() - t0:.1f} s")

    idx = os.path.join(work, "idx.taxor.npz")
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(work)  # the build writes its layout file (binning.out) here
    try:
        rc = cli.main(["build", "--input-file", tsv, "--input-sequence-dir",
                       gdir, "--output-filename", idx, "--kmer-size",
                       str(K), "--syncmer-size", str(S), "--use-syncmer",
                       "--layout", layout, "--threads", threads]
                      + (["--tmax", str(TMAX)] if layout == "auto" else []))
    finally:
        os.chdir(cwd)
    if rc != 0:
        raise RuntimeError(f"build failed ({rc})")
    from taxor_tpu_torch.hixf.index import load_index

    index = load_index(idx)
    ixfs = index.hixf.ixfs
    log(f"[{layout}] build: {time.perf_counter() - t0:.1f} s, {len(ixfs)} "
        f"IXF(s), root S={ixfs[0].fingerprints.shape[0]} x "
        f"B={ixfs[0].fingerprints.shape[1]} (block_length "
        f"{ixfs[0].block_length}), fingerprints "
        f"{sum(x.fingerprints.nbytes for x in ixfs) / 1e6:.1f} MB")

    # ---- the main path, counted
    out_dev = os.path.join(work, "device.tsv")
    reset_counts(extract, probe, sort, pipeline)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", reads,
                   "--output-file", out_dev, "--engine", "device",
                   "--device", "cuda", "--write-time", "--threads", threads])
    wall = time.perf_counter() - t0
    launches = read_counts(extract, probe, sort)
    routes = dict(pipeline.ROUTES.counts)
    if rc != 0:
        raise RuntimeError(f"device search failed ({rc})")
    if launches["K1"] <= 0 or launches["K2"] + launches["K2n"] <= 0:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    if layout == "flat" and launches["K2 slab"] <= 0:
        raise AssertionError(f"the flat path did not take K2's slab route: "
                             f"{launches}")
    with open(out_dev + ".time") as fh:
        phases = fh.read().strip().replace("\n", " | ")
    n_total = len(recs)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"[{layout}] main path: {n_total} reads in {wall:.2f} s wall = "
        f"{n_total / wall:.1f} reads/s; .time [{phases}]; launches "
        f"{launches}; routes {routes} (host-oracle fallback "
        f"{routes['host_fallback'] / n_total:.4f}); peak device memory "
        f"{peak:.1f} MiB")

    # ---- byte parity with the host engine on a subset
    sub = recs[:min(CHECK_READS, n_reads)] + recs[n_reads:]
    sub_fa = os.path.join(work, "subset.fasta")
    write_fasta(sub_fa, sub)
    out_host = os.path.join(work, "host.tsv")
    t0 = time.perf_counter()
    rc = cli.main(["search", "--index-file", idx, "--query-file", sub_fa,
                   "--output-file", out_host, "--engine", "host",
                   "--device", "cuda", "--threads", threads])
    if rc != 0:
        raise RuntimeError(f"host search failed ({rc})")
    ids = {rid for rid, _ in sub}
    dev_rows, host_rows = tsv_rows(out_dev, ids), tsv_rows(out_host)
    if dev_rows != host_rows:
        bad = next(i for i, (a, b) in enumerate(zip(dev_rows, host_rows))
                   if a != b) if len(dev_rows) == len(host_rows) else -1
        raise AssertionError(f"device TSV differs from host TSV (row {bad}, "
                             f"{len(dev_rows)} vs {len(host_rows)} rows)")
    log(f"[{layout}] parity: device TSV == host TSV byte for byte on "
        f"{len(sub)} reads ({len(host_rows)} rows; host engine "
        f"{time.perf_counter() - t0:.1f} s)")

    # ---- the split engine on the same reads, counted
    out_split = os.path.join(work, "split.tsv")
    reset_counts(extract, probe, sort, pipeline)
    torch.cuda.reset_peak_memory_stats()
    e2e.USE_FUSED_EXTRACT = False
    t0 = time.perf_counter()
    try:
        rc = cli.main(["search", "--index-file", idx, "--query-file", reads,
                       "--output-file", out_split, "--engine", "device",
                       "--device", "cuda", "--threads", threads])
    finally:
        e2e.USE_FUSED_EXTRACT = True
    wall_split = time.perf_counter() - t0
    split = read_counts(extract, probe, sort)
    split_routes = dict(pipeline.ROUTES.counts)
    if rc != 0:
        raise RuntimeError(f"split-engine search failed ({rc})")
    if split["K1"] != 0 or split["track"] <= 0 or split["K3"] <= 0:
        raise AssertionError(f"split engine: wrong kernels launched {split}")
    with open(out_dev, "rb") as fa, open(out_split, "rb") as fb:
        if fa.read() != fb.read():
            raise AssertionError("split-engine TSV differs from the K1 TSV")
    if tsv_rows(out_split, ids) != host_rows:
        raise AssertionError("split-engine TSV differs from the host TSV")
    log(f"[{layout}] split engine: {n_total} reads in {wall_split:.2f} s "
        f"wall = {n_total / wall_split:.1f} reads/s; TSV == K1 TSV on every "
        f"read and == host on {len(sub)}; launches {split}; routes "
        f"{split_routes}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    # ---- the result is right: a classified read names its source genome
    first = {}
    for row in tsv_rows(out_dev):
        rid, acc = row.split("\t", 2)[:2]
        first.setdefault(rid, acc)
    hits = [rid for rid, _ in recs if first.get(rid, "-") != "-"]
    right = sum(first[rid] == rid.split("_", 1)[1] for rid in hits)
    if right < 0.99 * len(hits):
        raise AssertionError(f"only {right} of {len(hits)} classified reads "
                             "name their source genome")
    log(f"[{layout}] accuracy: {len(hits)}/{n_total} reads classified, "
        f"{right} of them to their source genome")
    return {"index": index, "recs": recs, "launches": launches,
            "split": split, "routes": routes, "peak_mib": peak}


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
    fused = (launches["K2 routes"].get("fused", 0)
             + launches["K2n routes"].get("fused", 0))
    if fused <= 0 or counts_route <= 0 or state["routes"]["host_hashes"] <= 0:
        raise AssertionError(f"a route skipped the probe: {launches}")
    state["dh"] = dh


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
         # kmer + emit in; kmer, valid, counts out; a scan of the row and
         # the sort network over the emissions
         bound(9 * R * L + 9 * R * hcap + 8 * R,
               R * L + sort_ops(n_emit.tolist()), PEAK_SCALAR)),
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


def time_hier(torch, state) -> list[dict]:
    """K2n and K2 against their twin on the root group and on the first
    stacked level, at the hierarchical path's L=8192 bucket, with the
    descent's own activity masks."""
    from taxor_tpu_torch.search.thresholds import Thresholder
    from taxor_tpu_torch.device import extract, probe
    from taxor_tpu_torch.device.e2e import descend
    from taxor_tpu_torch.hash import device_syncmer as dsync

    dev = torch.device("cuda")
    dh = state["dh"]
    L = 8192
    seqs = bucket_reads(state["recs"], L)
    packed, lengths = dsync.pack_reads(seqs, L)
    hcap = dsync.hash_cap(L)
    hi, lo, valid, n_unique, _ = extract.syncmer_hashes(
        torch.from_numpy(packed).to(dev), torch.from_numpy(lengths).to(dev),
        K, S, (K - S + 1) // 2, hcap)
    th = Thresholder.make(K, K, 0.04, -1.0, True)
    thr = torch.from_numpy(dh._thr_table(th, hcap)).to(dev)[
        n_unique.clamp(0, hcap).long()]
    stacked = next(i for i, g in enumerate(dh.groups)
                   if g["tables"].shape[0] > 1)
    rows = []
    for label, gi in (("root", 0), ("stacked level", stacked)):
        g = dh.groups[gi]
        act = descend(dh.groups, len(dh.bfs_order), hi, lo, valid, thr,
                      upto=gi)
        a = (hi, lo, valid, g["tables"], act, g["seed"], g["bl"])
        plain = lambda: probe.probe_counts_grouped_plain(*a)  # noqa: E731
        for name, kern in (("probe_count_narrow", probe.k2n_counts),
                           ("probe_count", probe.k2_counts)):
            ms, plain_ms, err, each = time_pair(
                torch, lambda: kern(*a), plain, 20)  # noqa: B023
            if kern is probe.k2_counts:
                b = probe.slab_bins(*g["tables"].shape[1:], dev)
                name += f" ({f'slab of {b} bins' if b else 'rows'})"
            log(f"time {name} on the {label} group at R={len(seqs)}, "
                f"L={L}, H={hcap}, tables {tuple(g['tables'].shape)}, "
                f"{int(act.sum())}/{act.numel()} (subgroup, read) pairs "
                f"active: kernel {each[0]:.4f}/{each[1]:.4f} ms, plain "
                f"{each[2]:.3f}/{each[3]:.3f} ms")
            if label == "root" and name == "probe_count_narrow":
                G, S_, Bp = g["tables"].shape
                R, H = hi.shape
                active_hashes = float((act[:, :, None] & valid[None])
                                      .sum())
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "taxor_tpu_torch/csrc/probe_narrow.cu",
                    "replaces": "taxor_tpu/device/pallas_probe.py:578",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    **bound(9 * R * H + G * S_ * Bp + G * R
                            + 4 * G * R * Bp, active_hashes * Bp,
                            PEAK_INT8),
                    "library_ms": None})
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
    """{record name: launches} of the diagnostic wrappers (set to 0)."""
    out = {}
    for name, (fn, _, _) in DIAG.items():
        wrapper = getattr(diag, fn)
        out[name] = wrapper.LAUNCHES
        if zero:
            wrapper.LAUNCHES = 0
    return out


def check_diag(torch, flat_table, flat_bl: int, rng) -> None:
    """Phase 11: every diagnostic kernel against its twin, bit-exact."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words

    dev = torch.device("cuda")
    R, H = 256, 512
    t0 = time.perf_counter()
    tool_table = torch.from_numpy(pb.tool_table(rng)).to(dev)
    for label, table, bl in (("tool geometry", tool_table, pe.BL_TOOL),
                             ("flat cell", flat_table, flat_bl)):
        S1, B = table.shape
        n_np = rng.integers(0, H + 1, R).astype(np.int32)
        n_np[:8] = H  # full reads, and one with no hash
        n_np[8] = 0
        n_hash = torch.from_numpy(n_np).to(dev)
        rand16 = torch.from_numpy(pb.make_inputs(rng, R, H, S1)).to(dev)
        w16, w10 = (torch.from_numpy(x).to(dev)
                    for x in pe.make_inputs(rng, R, H, S1, bl))
        for mode in diag.PROBE_BOUNDS_MODES:
            assert_equal(torch, f"probe_bounds {mode} ({label})", ("counts",),
                         (diag.probe_bounds(table, rand16, n_hash, mode),),
                         (diag.probe_bounds_plain(table, rand16, n_hash,
                                                  mode),))
        runs = [dict(layout=lay, nr=nr) for lay in ("p16", "p10")
                for nr in (1, 2, 4)]
        runs += [dict(layout="p16", rounds=r) for r in (4, 8, 16)]
        runs += [dict(layout="p10", nr=2, rounds=4)]
        runs += [dict(flood_k=k) for k in (2, 4, 8)]
        first = None
        for kw in runs:
            w = w10 if kw.get("layout") == "p10" else w16
            got = diag.probe_experiment(table, w, n_hash, block_length=bl,
                                        **kw)
            assert_equal(torch, f"probe_experiment {kw} ({label})",
                         ("counts", "extra"), got,
                         diag.probe_experiment_plain(table, w, n_hash,
                                                     block_length=bl, **kw))
            if "flood_k" not in kw:  # the same counts in every layout
                first = got[0] if first is None else first
                assert_equal(torch, f"probe_experiment {kw} == p16",
                             ("counts",), (got[0],), (first,))
        log(f"probe_bounds (5 modes) and probe_experiment ({len(runs)} "
            f"runs) on the {label} [{S1}, {B}], R={R}, H={H} (bl {bl}): "
            f"bit-exact vs twins, p10 == p16, max count "
            f"{int(first.max())}")
    t = (K - S + 1) // 2
    for L in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        seqs = k1_reads(rng, L)
        packed, lengths = dsync.pack_reads(seqs, L)
        pk = torch.from_numpy(packed).to(dev)
        ln = torch.from_numpy(lengths).to(dev)
        want = diag.extract_stages_plain(pk, ln, K, S, t)
        for stage in diag.STAGES:
            assert_equal(torch, f"extract_stage {stage} L={L}", (stage,),
                         (diag.extract_stage(pk, ln, K, S, t, stage),),
                         (want[stage],))
        x = torch.from_numpy(stream_words(packed)).to(dev)
        assert_equal(torch, f"window_shift L={L}", ("words",),
                     (diag.window_shift(x),),
                     (diag.window_shift_plain(x, range(16)),))
        log(f"extract_stage (10 stages) and window_shift (16 phases) L={L}: "
            f"bit-exact vs twins on {len(seqs)} reads "
            f"({int(want['emit'].sum())} emissions)")
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


def tool_path(torch, modules, work: str) -> dict:
    """Phase 12: the tooling path through its entry points, the launch
    counts of every kernel set to 0 just before and read just after."""
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
    launches = read_counts(*modules[:3])
    log(f"tool path: probe_bounds ns/hash "
        f"{ {k: round(v['ns_per_hash'], 4) for k, v in bounds.items()} }")
    for name, rows in exps.items():
        log(f"tool path: probe_experiments {name}: "
            f"{[(r['mode'], r['U'], r['nops'], round(r['ms'], 4)) for r in rows]}")
    log(f"tool path: profile_phases ms {json.dumps(phases)}")
    log(f"tool path: seconds {({k: round(v, 1) for k, v in secs.items()})}; "
        f"diagnostic launches {counts}; search kernel launches {launches}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"the tooling path skipped a diagnostic kernel: "
                             f"{counts}")
    return counts


def time_diag(torch, state) -> list[dict]:
    """The four diagnostic kernels against their twins: the probe
    variants at the JAX tools' geometry (R=8192, H=512, 176 hashes a
    read, 2,419 slots x 512 bins), the stage dump (stage ``pre``, the
    tracker) and the window shift at the flat path's L=8192 bucket."""
    from taxor_tpu_torch.device import diag
    from taxor_tpu_torch.hash import device_syncmer as dsync
    from taxor_tpu_torch.tools import probe_bounds as pb
    from taxor_tpu_torch.tools import probe_experiments as pe
    from taxor_tpu_torch.tools.debug_min import stream_words

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
    rows = []
    for name, shape, fn, plain, reps, bnd in cases:
        ms, plain_ms, err, each = time_pair(torch, fn, plain, reps)
        log(f"time {name} ({shape}): kernel {each[0]:.4f}/{each[1]:.4f} ms, "
            f"plain {each[2]:.3f}/{each[3]:.3f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append({"name": name, "route": "cuda", "source": DIAG[name][1],
                     "replaces": DIAG[name][2], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, **bnd, "library_ms": None})
    return rows


def main() -> int:
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
    check_k1(torch, dsync, extract, sort, rng)
    k2_rows_checks = check_k2(torch, probe, rng)
    check_sorts(torch, sort, rng)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "taxor_tpu_torch", "_build")
    os.makedirs(root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=root)
    try:
        flat = main_path(torch, os.path.join(work, "flat"), rng, args.genomes,
                         args.reads, "flat")
        kernels = time_kernels(torch, flat)
        kernels += time_split(torch, flat)
        shutil.rmtree(os.path.join(work, "flat"), ignore_errors=True)
        k2_rows_checks += check_grouped(torch, probe, rng)
        hier = main_path(torch, os.path.join(work, "hier"), rng,
                         args.hier_genomes, args.hier_reads, "auto")
        hier_report(torch, hier)
        kernels += time_hier(torch, hier)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for row in kernels:  # launches on both main paths, both engines
        key = {"syncmer_extract": "K1", "probe_count": "K2 slab",
               "probe_count_rows": "K2 rows", "probe_count_narrow": "K2n",
               "syncmer_track": "track", "dedup": "K3",
               "sort_pairs": "K4"}[row["name"]]
        row["launches"] = sum(run[key] for path in (flat, hier)
                              for run in (path["launches"], path["split"]))
        row["launches_in"] = "main paths"
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
    check_diag(torch, dh.table, dh.block_length,
               np.random.default_rng(SEED + 11))
    checks = diag_counts(diag)
    del dh
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_", dir=root)
    try:
        tools = tool_path(torch, (extract, probe, sort, pipeline), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 12: tooling path in {time.perf_counter() - t0:.1f} s")
    for row in time_diag(torch, flat):
        row.update(launches=tools[row["name"]], launches_in="tools",
                   tool_launches=tools[row["name"]],
                   check_launches=checks[row["name"]])
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
