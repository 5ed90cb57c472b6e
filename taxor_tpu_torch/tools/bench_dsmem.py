"""The rate of distributed shared memory on the card: random 16-byte row
reads from another block of a thread-block cluster against the block's
own, each mode of csrc/diag/dsmem.cu held to its twin, then timed.

    python -m taxor_tpu_torch.tools.bench_dsmem [--clusters 2,4,8,16]
        [--modes local,remote,spread,word,stream] [--rows-log2 13]
        [--iters 4096] [--device cuda]

For each cluster size C and mode (``device/diag.DSMEM_MODES``) the kernel
runs as many clusters as the card holds at once
(``diag.dsmem_clusters``), 1,024 threads a block and 2^rows_log2 rows of
16 bytes a block (128 KiB at 13: one block an SM); it is held bit-exact
to ``diag.dsmem_rows_plain`` on one cluster at 16 reads a thread, then
timed over ``--iters`` reads a thread (CUDA events, the best of 3 means
of 5 launches).  One JSON line goes to stdout: nvidia-smi's name and
power limit, and per (C, mode) the clusters, ms, reads and TB/s (16
bytes a read, 4 in mode ``word``); exit code 1 when a mode differs from
its twin.  These rates chose the layout of K2's slab route for tables
too tall for a 16-bin slab: thin slabs of every slot in each block
(csrc/probe_slab.cu) over a slab split across a cluster
(csrc/probe_cluster.cu).  With ``--device cpu`` it runs the twin alone at
a small size (a check of the tool, no device time).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from taxor_tpu_torch.device import diag
from taxor_tpu_torch.tools.bench import card_line, log


def timed_ms(fn, reps: int = 5) -> float:
    """Milliseconds a call of fn(), the best of 3 means over ``reps``
    calls between two CUDA events, after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best


def run(args) -> dict:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    sizes = [int(c) for c in args.clusters.split(",")]
    modes = args.modes.split(",")
    out = {"device": card_line() if dev.type == "cuda" else "cpu",
           "rows_log2": args.rows_log2, "iters": args.iters, "equal": True,
           "rates": {}}
    for C in sizes:
        for mode in modes:
            want = diag.dsmem_rows_plain(mode, C, 1, args.rows_log2, 16)
            got = diag.dsmem_rows(mode, C, 1, args.rows_log2, 16, dev)
            equal = torch.equal(got.cpu(), want)
            out["equal"] &= equal
            rec = {"equal": equal}
            if dev.type == "cuda":
                n = diag.dsmem_clusters(mode, C, args.rows_log2, dev)
                ms = timed_ms(lambda: diag.dsmem_rows(
                    mode, C, n, args.rows_log2, args.iters, dev))
                reads = n * C * diag.DSMEM_THREADS * args.iters
                width = 4 if mode == "word" else 16
                rec.update(clusters=n, ms=ms, reads=reads,
                           tbps=reads * width / ms / 1e9)
                log(f"bench_dsmem C={C:2d} {mode:6s} {n:3d} clusters "
                    f"{ms:8.4f} ms {rec['tbps']:7.3f} TB/s "
                    f"(== twin: {equal})")
            out["rates"][f"{C}/{mode}"] = rec
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clusters", default="2,4,8,16",
                    help="cluster sizes, powers of two up to 16")
    ap.add_argument("--modes", default=",".join(diag.DSMEM_MODES))
    ap.add_argument("--rows-log2", type=int, default=13,
                    help="log2 of the 16-byte rows a block holds")
    ap.add_argument("--iters", type=int, default=4096,
                    help="reads a thread in the timed launches")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, or cpu for the "
                         "plain twin)")
    out = run(ap.parse_args(argv))
    print(json.dumps(out), flush=True)
    return 0 if out["equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
