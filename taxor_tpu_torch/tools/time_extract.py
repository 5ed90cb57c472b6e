"""K1 and syncmer_track on one length bucket, on random reads and on
reads tied in every window (the tracker's worst case), each held
bit-exact to its plain twin, then timed.

    python -m taxor_tpu_torch.tools.time_extract [--L 8192] [--reads 512]
        [--device cuda]

Random reads are uniform over ACGT with lengths uniform over (L/2, L],
the bucket's range; tied reads (``all_tied_reads``) are homopolymers and
tandem repeats of period 2-5, each a single tied run that the kernels'
resolver replays whole (csrc/tracker.cuh).  Every run times both
SCHEMES on the same reads (t = (k - s + 1) // 2): k = 22, s = 12, the
main scheme, through the kernels' 32-bit s-mer instances, and k = 28,
s = 18 through their 64-bit ones.  Each kernel gets two times
on the same inputs, after a warm-up call: ``<name>_ms``, a call as a
caller sees it (the best of 3 means of 10 calls between CUDA events; on
the CPU, ``time.perf_counter``), and ``<name>_device_ms``, the kernel
alone (``time_sort.device_ms``: the same with the launches queued behind
a sleep kernel, so the host's gaps between calls are not timed; on the
CPU, as the first).  The reads cannot be rolled as ``timing.rolled_ms``
rolls them without their lengths, and a batch's 1 MB of packed reads
sits in the L2 cache of any caller.  One JSON line goes to stdout:
nvidia-smi's name and power limit, and per scheme ("22/12", "28/18")
and batch the emissions and each kernel's milliseconds; exit code 1
when a kernel differs from its twin.
With ``--device cpu`` it runs the twins (a check of the tool, no device
time).

To compare checkouts, run this file against each in turns in one call
to the card: ``PYTHONPATH=<checkout> python <this file>``.  It imports
the package by its absolute name, so the same file drives any checkout
whose ``hash_cap`` takes the scheme and whose kernels take s >= 16.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from taxor_tpu_torch.device import extract
from taxor_tpu_torch.hash import device_syncmer as dsync
from taxor_tpu_torch.tools.bench import card_line, log

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
# (k, s): the main scheme, and one of 64-bit s-mers
SCHEMES = ((22, 12), (28, 18))
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


def measure(seqs: list[bytes], L: int, dev: torch.device, k: int,
            s: int) -> dict:
    """{emissions, equal, K1 and syncmer_track ms a call and on the
    device alone} of one batch under scheme (k, s)."""
    from taxor_tpu_torch.tools.time_sort import device_ms

    t = (k - s + 1) // 2
    hcap = dsync.hash_cap(L, k, s, t)
    packed, lengths = dsync.pack_reads(seqs, L)
    pk = torch.from_numpy(packed).to(dev)
    ln = torch.from_numpy(lengths).to(dev)
    got = extract.syncmer_hashes(pk, ln, k, s, t, hcap)
    want = extract.syncmer_hashes_plain(pk, ln, k, s, t, hcap)
    track = extract.syncmer_track(pk, ln, k, s, t)
    equal = (all(torch.equal(a, b) for a, b in zip(got, want))
             and all(torch.equal(a, b) for a, b in zip(
                 track, dsync.syncmer_kmers(pk, ln, k, s, t))))
    out = {"reads": len(seqs), "emissions": int(got[4].sum()),
           "equal": equal}
    for name, fn in (
            ("syncmer_extract",
             lambda: extract.syncmer_hashes(pk, ln, k, s, t, hcap)),
            ("syncmer_track", lambda: extract.syncmer_track(pk, ln, k, s, t))):
        out[f"{name}_ms"] = best_ms(fn, dev)
        out[f"{name}_device_ms"] = (device_ms(fn) if dev.type == "cuda"
                                    else out[f"{name}_ms"])
    return out


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
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "L": args.L}
    for k, s in SCHEMES:
        rng = np.random.default_rng(SEED)  # each scheme on the same reads
        rec = out[f"{k}/{s}"] = {}
        for name, make in (("random", random_reads), ("all_tied",
                                                      all_tied_reads)):
            rec[name] = measure(make(rng, args.L, args.reads), args.L, dev,
                                k, s)
            log(f"time_extract k={k} s={s} {name}: {rec[name]}")
    print(json.dumps(out))
    return 0 if all(out[f"{k}/{s}"][name]["equal"] for k, s in SCHEMES
                    for name in ("random", "all_tied")) else 1


if __name__ == "__main__":
    sys.exit(main())
