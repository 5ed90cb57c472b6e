"""K1 and syncmer_track on one length bucket, on random reads and on
reads tied in every window (the tracker's worst case), each held
bit-exact to its plain twin, then timed.

    python -m taxor_tpu_torch.tools.time_extract [--L 8192] [--reads 512]
        [--device cuda]

Random reads are uniform over ACGT with lengths uniform over (L/2, L],
the bucket's range; tied reads (``all_tied_reads``) are homopolymers and
tandem repeats of period 2-5, each a single tied run that the kernels'
resolver replays whole (csrc/tracker.cuh).  A time is the best of 3
means of 10 calls on the same inputs (CUDA events; on the CPU,
``time.perf_counter``), after a warm-up call: the reads cannot be rolled
as ``timing.rolled_ms`` rolls them without their lengths, and a batch's
1 MB of packed reads sits in the L2 cache of any caller.  One JSON line
goes to stdout: nvidia-smi's name and power limit, and per batch the
emissions and each kernel's milliseconds; exit code 1 when a kernel
differs from its twin.  To
compare two checkouts, run it from each (``PYTHONPATH=<checkout>``) in
one call to the card, in turns.  With ``--device cpu`` it runs the twins
(a check of the tool, no device time).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import extract
from ..hash import device_syncmer as dsync
from .bench import card_line, log

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
K, S = 22, 12
SEED = 20261016


def random_reads(rng, L: int, n: int) -> list[bytes]:
    """n reads over ACGT with lengths uniform over (L/2, L]."""
    return [ACGT[rng.integers(0, 4, int(rng.integers(L // 2 + 1, L + 1)))]
            .tobytes() for _ in range(n)]


def all_tied_reads(rng, L: int, n: int) -> list[bytes]:
    """n reads of L bases tied in every window for w >= 6 (w = 11 at
    k=22/s=12): homopolymers and tandem repeats of period 2-5, whose
    every window holds each s-mer twice or more."""
    seqs = []
    for j in range(n):
        unit = ACGT[rng.integers(0, 4, 1 + j % 5)].tobytes()
        seqs.append((unit * (L // len(unit) + 1))[:L])
    return seqs


def best_ms(fn, device: torch.device, M: int = 10) -> float:
    """Milliseconds per call of fn(), the best of 3 means over M calls,
    after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(M):
                fn()
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b) / M
        else:
            t0 = time.perf_counter()
            for _ in range(M):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / M
        best = min(best, ms)
    return best


def measure(seqs: list[bytes], L: int, dev: torch.device) -> dict:
    """{emissions, equal, K1 ms, syncmer_track ms} of one batch."""
    t = (K - S + 1) // 2
    hcap = dsync.hash_cap(L)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = extract.syncmer_hashes(pk, ln, K, S, t, hcap)
    want = extract.syncmer_hashes_plain(pk, ln, K, S, t, hcap)
    track = extract.syncmer_track(pk, ln, K, S, t)
    equal = (all(torch.equal(a, b) for a, b in zip(got, want))
             and all(torch.equal(a, b) for a, b in zip(
                 track, dsync.syncmer_kmers(pk, ln, K, S, t))))
    return {
        "reads": len(seqs), "emissions": int(got[4].sum()), "equal": equal,
        "syncmer_extract_ms": best_ms(
            lambda: extract.syncmer_hashes(pk, ln, K, S, t, hcap), dev),
        "syncmer_track_ms": best_ms(
            lambda: extract.syncmer_track(pk, ln, K, S, t), dev)}


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
    rng = np.random.default_rng(SEED)
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "L": args.L, "k": K, "s": S}
    for name, make in (("random", random_reads), ("all_tied",
                                                  all_tied_reads)):
        out[name] = measure(make(rng, args.L, args.reads), args.L, dev)
        log(f"time_extract {name}: {out[name]}")
    print(json.dumps(out))
    return 0 if out["random"]["equal"] and out["all_tied"]["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
