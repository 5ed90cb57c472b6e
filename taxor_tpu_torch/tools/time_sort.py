"""K3 (dedup) and K4 (pair sort) on one length bucket, each held
bit-exact to its plain twin, then timed; and the rows that check every
branch of their register network.

    python -m taxor_tpu_torch.tools.time_sort [--L 8192] [--reads 512]
        [--device cuda]

The batch is ``chip_smoke.py`` phase 10's shape: R reads of the L bucket
(random reads over ACGT with lengths uniform over (L/2, L], as
``time_extract.random_reads`` makes them), their per-position k-mers and
emissions from ``syncmer_track`` at k=22/s=12/t=5, hcap = ``hash_cap(L,
22, 12, 5)``.  K3 dedups them (``sort.dedup_fused``); K3 again on the
same k-mers with ``emit`` all false times its gather and writes alone;
K4 sorts the rows of (hi, lo) of the k-mers with every position that
emits nothing set to the all-ones sentinel (``sort.sort_pairs``), and
``torch.sort`` of the same keys as int64 is timed beside it (a
yardstick, unused by the port).  Each gets two times, on the same inputs
after a warm-up call: ``<name>_ms``, a call as a caller sees it
(``time_extract.best_ms``: the best of 3 means of 10 calls between CUDA
events, the host's Python and launch gaps included), and
``<name>_device_ms``, the kernel alone (``device_ms``: the same, with
the 10 launches queued behind a sleep kernel before the first starts).
A kernel faster than the host's ~0.025 ms a call shows only in the
second.  On the CPU both are ``time.perf_counter`` times.  One JSON line
goes to stdout: nvidia-smi's name and power limit, the emissions a read
(mean, min, max) and the times; exit code 1 when a kernel differs from
its twin.  With ``--device cpu`` it runs the twins (a check of the tool,
no device time).

To compare two checkouts, run this file from each in turns (parent,
change, change, parent) in one call to the card:
``PYTHONPATH=<checkout> python <this file>``.  It imports the package by
its absolute name, so the same file drives an older checkout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from taxor_tpu_torch.device import extract, sort
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.tools.bench import card_line, log
from taxor_tpu_torch.tools.time_extract import best_ms, random_reads
from taxor_tpu_torch.utils.u64 import INT64_MIN, join32, split32

K, S, T = 22, 12, 5
SEED = 20261017
SENT = np.uint64(0xFFFFFFFFFFFFFFFF)
# device_ms's sleep: ~20 ms at 1.98 GHz, far longer than the host takes
# to enqueue the calls it times
HEAD_START_CYCLES = 40_000_000
# K4's merge route (rows past 16,384 keys): one merge pass, a width that
# is no power of two, the union's widths of 32 pieces and past them, up
# to 2^20 (the union of 32 pieces of a narrow syncmer scheme)
MERGE_WIDTHS = (16385, 32768, 65536, 100000, 262144, 524288, 1048576)
# K4 widths the checks run: sizes below a warp, odd widths, the register
# route at E = 16 and 32, and the merge route
PAIR_WIDTHS = (1, 2, 31, 100, 128, 1024, 8192, 16384) + MERGE_WIDTHS


def pair_rows(rng, R: int, W: int):
    """uint32 (hi, lo) [R, W] rows with every key twice, hi words of
    0-3 and 2^32-4 .. 2^32-1 (keys next to the sentinel), keys equal to
    the all-ones sentinel, a row of all-equal keys, a row that is all
    sentinel, a row of three distinct keys and a row of long equal runs
    in descending order (the merge route's cuts fall inside runs of equal
    keys, and a tile takes all of its keys from one run)."""
    hi = rng.integers(-4, 4, (R, W), dtype=np.int32).view(np.uint32)
    lo = rng.integers(0, 1 << 32, (R, W), dtype=np.uint32)
    hi[:, 1::2] = hi[:, ::2][:, :W // 2]
    lo[:, 1::2] = lo[:, ::2][:, :W // 2]
    hi[:, ::7] = 0xFFFFFFFF
    lo[:, ::7] = 0xFFFFFFFF
    hi[0], lo[0] = 3, 12345
    if R > 1:
        hi[1], lo[1] = 0xFFFFFFFF, 0xFFFFFFFF
    if R > 2:
        hi[2] = rng.integers(0, 3, W, dtype=np.uint32)
        lo[2] = hi[2] * np.uint32(7)
    if R > 3:
        hi[3] = np.sort(rng.integers(0, 8, W, dtype=np.uint32))[::-1]
        lo[3] = hi[3] * np.uint32(7)
    return hi, lo


def emission_counts(L: int, min_gap: int) -> list[int]:
    """Emission counts m a read that reach every branch of K3: 0, 1, one
    warp of keys and one either side, 32E +- 1 for every E the kernel
    takes (the first merge whose strides leave a warp), its buffer Wb,
    and Wb + 1 (the overflow) where a row of L positions holds it."""
    Wb = sort.dedup_width(L, min_gap)
    counts = {0, 1, 31, 32, 33, Wb}
    counts |= {32 * E + d for E in (8, 16, 32) for d in (-1, 1)}
    counts = sorted(c for c in counts if c <= Wb)
    return counts + ([Wb + 1] if Wb < L else [])


def emission_rows(rng, L: int, counts, min_gap: int):
    """(kmer uint64, emit bool) [len(counts) + 2, L]: a row a count, its
    emissions min_gap apart where min_gap leaves room (else anywhere),
    k-mers with repeats; then a row of all-equal k-mers and a row whose
    every third k-mer equals the sentinel, both emitting every min_gap."""
    R = len(counts) + 2
    kmer = rng.integers(0, 1 << 12, (R, L), dtype=np.uint64) << np.uint64(40)
    kmer |= rng.integers(0, 64, (R, L), dtype=np.uint64)
    emit = np.zeros((R, L), dtype=bool)
    cols = np.arange(0, L, min_gap)
    for r, c in enumerate(list(counts) + [cols.size, cols.size]):
        pool = cols if c <= cols.size else np.arange(L)
        emit[r, np.sort(rng.choice(pool, c, replace=False))] = True
    kmer[-2] = 77
    kmer[-1, ::3] = SENT
    return kmer, emit


def device_ms(fn, M: int = 10, rounds: int = 3) -> float:
    """Milliseconds a call of fn() takes on the CUDA device alone: the
    best of `rounds` means over M calls whose launches all queue behind a
    sleep kernel before the first of them starts, so the host's gaps
    between calls (Python, allocation, the launch) are not timed; after
    one warm-up call.  ``chip_smoke.py`` times with it too; it lives here
    so that this file still runs against an older checkout."""
    fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HEAD_START_CYCLES)
        a.record()
        for _ in range(M):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / M)
    return best


def batch(L: int, R: int, dev: torch.device):
    """Phase 10's batch: syncmer_track's k-mers and emissions of R random
    reads of the L bucket."""
    seqs = random_reads(np.random.default_rng(SEED), L, R)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    return extract.syncmer_track(pk, ln, K, S, T)


def equal(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--L", type=int, default=8192, help="length bucket")
    ap.add_argument("--reads", type=int, default=512,
                    help="reads a batch (512 fill the L=8192 bucket)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twins)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    L = args.L
    hcap = dsync.hash_cap(L, K, S, T)
    gap = dsync.emission_min_gap(K, S, T)
    kmer, emit = batch(L, args.reads, dev)
    none = torch.zeros_like(emit)
    hi, lo = split32(torch.where(emit, kmer, torch.full_like(kmer, -1)))
    keys = join32(hi, lo) ^ INT64_MIN  # int64 order = the u64 order
    n = emit.sum(dim=1)
    eq = {
        "dedup": equal(sort.dedup_fused(kmer, emit, hcap, gap),
                       sort.dedup_fused_plain(kmer, emit, hcap, gap)),
        "dedup_no_emit": equal(sort.dedup_fused(kmer, none, hcap, gap),
                               sort.dedup_fused_plain(kmer, none, hcap,
                                                      gap)),
        "sort_pairs": equal(sort.sort_pairs(hi, lo),
                            sort.sort_pairs_plain(hi, lo))}
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "L": L, "reads": args.reads, "hcap": hcap,
           "dedup_width": sort.dedup_width(L, gap),
           "emissions": {"mean": float(n.float().mean()),
                         "min": int(n.min()), "max": int(n.max())},
           "equal": eq}
    for name, fn in (
            ("dedup", lambda: sort.dedup_fused(kmer, emit, hcap, gap)),
            ("dedup_no_emit",
             lambda: sort.dedup_fused(kmer, none, hcap, gap)),
            ("sort_pairs", lambda: sort.sort_pairs(hi, lo)),
            ("torch_sort", lambda: torch.sort(keys, dim=1))):
        out[f"{name}_ms"] = best_ms(fn, dev)
        out[f"{name}_device_ms"] = (device_ms(fn) if dev.type == "cuda"
                                    else best_ms(fn, dev))
    log(f"time_sort: {out}")
    print(json.dumps(out))
    return 0 if all(eq.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
